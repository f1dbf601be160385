"""ray_tpu_torch.rllib's SAC, DDPG/TD3, MARWIL/BC with offline data, and
the local paths of A3C and Ape-X, held against ray_tpu.rllib on the CPU.

Every learner run of ``chip_smoke.RL_MORE_RUNS`` runs live on both sides
here (``tests/rllib_reference.py`` drives the JAX learner; the port's
side is ``chip_smoke.rl_more_outputs``): the same numpy draws in the
reference's layout, the same minibatches, and for SAC and TD3 the
Gaussian draws the JAX learner makes from its learn key, fed to the
port.  Float32 on both sides.  Tolerances, each with its reason:

- the recorded params, targets and ``log_alpha`` after the update: 1e-5
  of the leaf's largest magnitude (the target for one update; sums in
  other orders, seen at most 1e-7); every other leaf's update (after −
  before): 1e-3 relative L2 (Adam's first step divides by |g| + 1e-8,
  which magnifies float32 noise in gradients near 1e-8: seen at most
  1.8e-4, Ape-X's conv dense layer), exactly 0 where JAX's is;
- statistics, gradient norms and leaves, ``|td|``: 1e-4 of the largest
  magnitude (``chip_smoke.RL_OUT_TOL``; seen at most 3e-6);
- deterministic actions: 1e-5 (tanh of one network output);
- ``compute_gradients``: every leaf of the numpy gradient tree to 1e-5
  of its largest magnitude.

Sampling cannot match JAX's bits: SAC's exploration is held by
distribution (the pre-tanh sample's mean and std within 5 standard
errors).  ``PrioritizedReplay`` and the offline data plane are numpy on
both sides and must agree exactly.
"""

import importlib
import json
import math

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import rllib_reference
from ray_tpu.rllib import offline as joffline
from ray_tpu.rllib.algorithms import apex as japex
from ray_tpu.rllib.algorithms import ddpg as jddpg
from ray_tpu.rllib.algorithms import sac as jsac
from ray_tpu.rllib.evaluation import RolloutWorker as JRolloutWorker
from ray_tpu.rllib.sample_batch import SampleBatch as JSampleBatch
from ray_tpu_torch.rllib import (APEXConfig, Policy, RolloutWorker,
                                 SampleBatch, TD3Config, offline, register_env)
from ray_tpu_torch.rllib import models as tm
from ray_tpu_torch.rllib.algorithms import apex as tapex
from ray_tpu_torch.rllib.algorithms import ddpg as tddpg
from ray_tpu_torch.rllib.algorithms import sac as tsac

CPU = torch.device("cpu")
PARAM_TOL = chip_smoke.RL_PARAM_TOL
OUT_TOL = chip_smoke.RL_OUT_TOL


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ------------------------------------------------------------- learners
@pytest.mark.parametrize("run", chip_smoke.RL_MORE_RUNS)
def test_update_matches_live_jax(run):
    """One SAC and DDPG update, two TD3 updates (an actor step and a
    skipped one), two MARWIL updates with c² carried and two of BC, A3C's
    compute_gradients and apply, one Ape-X update: every recorded entry,
    and every leaf of every tree after the update."""
    rec, before, after = rllib_reference.more_outputs(run)
    draws = {k[5:]: v for k, v in rec.items() if k.startswith("draw/")}
    got, got_before, got_after = chip_smoke.rl_more_outputs(run, CPU, draws)
    assert set(got) == {k for k in rec if not k.startswith("draw/")}
    for key, g in got.items():
        tol = PARAM_TOL if key.startswith("param/") else OUT_TOL
        assert _err(g, rec[key]) <= tol, (key, g, rec[key])
    assert set(got_after) == set(after)
    for name, tree in after.items():
        if not isinstance(tree, dict):                # SAC's log_alpha
            assert _err(got_after[name], tree) <= PARAM_TOL, name
            continue
        b = dict(chip_smoke.rl_tree_paths(before[name]))
        for path, x in chip_smoke.rl_tree_paths(got_before[name]):
            np.testing.assert_array_equal(x, b[path])
        g = dict(chip_smoke.rl_tree_paths(got_after[name]))
        for path, ref in chip_smoke.rl_tree_paths(tree):
            d_ref = np.asarray(ref, np.float64) - b[path]
            d_got = np.asarray(g[path], np.float64) - b[path]
            if not d_ref.any():
                assert not d_got.any(), (name, path)
                continue
            assert np.linalg.norm(d_got - d_ref) <= \
                1e-3 * np.linalg.norm(d_ref), (name, path)


def _ddpg_algo(run):
    """The port's DDPG/TD3 of ``run`` on the CPU with its drawn state and
    minibatches (as ``chip_smoke.rl_more_outputs`` sets them)."""
    register_env("PendulumLite", lambda c: chip_smoke.PendulumLite(c))
    algo = {"ddpg_mlp": tddpg.DDPGConfig, "td3_mlp": TD3Config}[run]().update(
        dict(chip_smoke.rl_config(run), device="cpu")).build()
    rng = np.random.default_rng((chip_smoke.RL_SEED,
                                 chip_smoke.RL_RUNS.index(run)))
    leaves = lambda t: [(p, v.shape) for p, v in  # noqa: E731
                        chip_smoke.rl_tree_paths(t)]
    state = chip_smoke.rl_offpolicy_state(
        run, rng, leaves(algo.get_policy().get_weights()["params"]),
        leaves(algo.get_learner_state()["q1"]))
    algo.get_policy().set_weights({"params": state["actor"]})
    algo.set_learner_state({k: v for k, v in state.items() if k != "actor"})
    draws = {"noise": np.zeros((2, chip_smoke.RL_CONTINUOUS_ROWS, 1),
                               np.float32)}
    return algo, state, chip_smoke.rl_minibatches(run, rng, draws)


def test_td3_actor_and_its_adam_count_move_only_on_actor_steps():
    algo, state, mbs = _ddpg_algo("td3_mlp")
    noise = torch.zeros((chip_smoke.RL_CONTINUOUS_ROWS, 1))
    counts, actors, targets = [], [], []
    for mb in mbs + mbs[:1]:
        algo.learn_on({k: torch.from_numpy(v) for k, v in mb.items()},
                      noise)
        counts.append(int(algo._actor_state[0]["count"]))
        actors.append(tm.params_to_numpy(algo.get_policy().params))
        targets.append(algo.get_learner_state()["actor_t"])
    assert counts == [1, 1, 2]
    assert int(algo._critic_state[0]["count"]) == 3
    for a, b in ((actors[0], actors[1]), (targets[0], targets[1])):
        for (_, x), (_, y) in zip(chip_smoke.rl_tree_paths(a),
                                  chip_smoke.rl_tree_paths(b)):
            np.testing.assert_array_equal(x, y)
    assert not np.array_equal(actors[1]["q_0"]["w"], actors[2]["q_0"]["w"])
    assert not np.array_equal(state["actor_t"]["q_0"]["w"],
                              targets[0]["q_0"]["w"])


def test_ddpg_q2_gets_zero_gradients_and_stays():
    algo, state, mbs = _ddpg_algo("ddpg_mlp")
    algo.learn_on({k: torch.from_numpy(v) for k, v in mbs[0].items()},
                  None)
    q2 = algo.get_learner_state()["q2"]
    for (_, x), (_, y) in zip(chip_smoke.rl_tree_paths(q2),
                              chip_smoke.rl_tree_paths(state["q2"])):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fault,run", [
    ("sac_tanh_transform", "sac_mlp"),
    ("td3_actor_every_update", "td3_mlp"),
    ("marwil_pre_update_c2", "marwil_mlp"),
    ("apex_no_is_weights", "apex_conv")])
def test_planted_fault_fails_by_a_wide_factor(fault, run, monkeypatch):
    rec = rllib_reference.more_outputs(run)[0]
    ref = {k: rllib_reference._entry(v) for k, v in rec.items()}
    module, attr, plant = chip_smoke.RL_FAULTS[fault]
    mod = importlib.import_module(f"ray_tpu_torch.{module}")
    monkeypatch.setattr(mod, attr, plant(getattr(mod, attr)))
    ratio, worst, _ = chip_smoke.rl_errors(run, ref, CPU)
    assert ratio > 100.0, (fault, worst, ratio)


def test_sac_logp_is_the_reference_formula_inside_the_band():
    """The tanh correction in float64 (no float32 tanh in the way) is the
    reference's formula at every pre-tanh value, the band where float32
    cannot hold it included; TanhTransform's Jacobian (no 1e-6) is not.
    The whole log-probability, in float32 outside the band, against the
    formula in float64."""
    pre = torch.linspace(-12.0, 12.0, 241, dtype=torch.float64)[:, None]
    a = np.tanh(pre.numpy())
    ref = np.log(1 - a ** 2 + 1e-6)[:, 0]
    got = tsac.tanh_log_det(pre, torch.tanh(pre)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)
    fault = chip_smoke._rl_tanh_transform(None)(pre, torch.tanh(pre))
    band = np.abs(pre.numpy()[:, 0]) > chip_smoke.SAC_BAND[0]
    assert np.abs(fault.numpy() - ref)[band].max() > 1e-3
    rng = np.random.default_rng(5)
    params = {"q_0": {"w": (0.2 * rng.standard_normal((3, 2))).astype(
                          np.float32),
                      "b": np.float32([0.1, -0.4])}}
    obs = rng.standard_normal((64, 3)).astype(np.float32)
    eps = rng.standard_normal((64, 1)).astype(np.float32)
    act, logp = tsac.sample_squashed(
        tm.params_from_numpy(params, tm.ModelConfig(3, 2, ()), CPU),
        torch.from_numpy(obs), torch.from_numpy(eps), 1)
    out = obs.astype(np.float64) @ params["q_0"]["w"] + params["q_0"]["b"]
    log_std = np.clip(out[:, 1:], -20, 2)
    x = out[:, :1] + np.exp(log_std) * eps
    ref = (-0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))
           - np.log(1 - np.tanh(x) ** 2 + 1e-6)).sum(-1)
    assert np.abs(x).max() < chip_smoke.SAC_BAND[0]
    np.testing.assert_allclose(act.numpy(), np.tanh(x), atol=1e-6)
    np.testing.assert_allclose(logp.numpy(), ref, rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------- policies
def _pendulum_spaces():
    e = chip_smoke.PendulumLite()
    return e.observation_space, e.action_space


@pytest.mark.parametrize("kind", ["sac", "ddpg"])
def test_policy_actions_match_jax_on_carried_weights(kind):
    jcls, tcls = {"sac": (jsac.SACPolicy, tsac.SACPolicy),
                  "ddpg": (jddpg.DDPGPolicy, tddpg.DDPGPolicy)}[kind]
    cfg = {"fcnet_hiddens": (16, 16), "seed": 3}
    jpol = jcls(*_pendulum_spaces(), cfg)
    tpol = tcls(*_pendulum_spaces(), dict(cfg, device="cpu"))
    drawn = chip_smoke.rl_draw_tree(np.random.default_rng(0), [
        (p, v.shape) for p, v in chip_smoke.rl_tree_paths(
            jpol.get_weights()["params"])])
    jpol.set_weights({"params": drawn})
    tpol.set_weights({"params": drawn})
    for (_, x), (_, y) in zip(
            chip_smoke.rl_tree_paths(tpol.get_weights()["params"]),
            chip_smoke.rl_tree_paths(drawn)):
        np.testing.assert_array_equal(x, y)
    obs = np.random.default_rng(1).standard_normal((16, 3)).astype(
        np.float32)
    modes = (False, True) if kind == "ddpg" else (False,)
    for explore in modes:      # DDPG's noise: the reference's numpy draw
        ja, jx = jpol.compute_actions(obs, explore=explore)
        ta, tx_ = tpol.compute_actions(obs, explore=explore)
        assert ta.shape == ja.shape == (16, 1) and ta.dtype == np.float32
        assert _err(ta, ja) <= 1e-5
        assert _err(tx_["raw_action"], jx["raw_action"]) <= 1e-5
        assert set(tx_) == set(jx)
    ta, extras = tpol.compute_actions(obs, explore=True)
    assert (ta >= tpol.low).all() and (ta <= tpol.high).all()
    assert np.abs(extras["raw_action"]).max() <= 1.0
    a, ext = tpol.compute_single_action(obs[0])
    assert a.shape == (1,) and ext["raw_action"].shape == (1,)


def test_sac_sampling_by_distribution():
    """The pre-tanh exploration sample of fixed observations: mean and std
    within 5 standard errors of the actor's (JAX's ``_actor_apply`` on the
    same weights)."""
    cfg = {"fcnet_hiddens": (16, 16), "seed": 0}
    tpol = tsac.SACPolicy(*_pendulum_spaces(), dict(cfg, device="cpu"))
    jpol = jsac.SACPolicy(*_pendulum_spaces(), cfg)
    drawn = chip_smoke.rl_draw_tree(np.random.default_rng(2), [
        (p, v.shape) for p, v in chip_smoke.rl_tree_paths(
            jpol.get_weights()["params"])])
    tpol.set_weights({"params": drawn})
    obs = np.random.default_rng(3).standard_normal((2, 3)).astype(np.float32)
    mean, log_std = jax.jit(lambda o: jsac._actor_apply(
        jax.tree_util.tree_map(np.asarray, drawn), o, 3))(obs)
    mean, std = np.asarray(mean)[:, 0], np.exp(np.asarray(log_std))[:, 0]
    n = 4000
    _, extras = tpol.compute_actions(np.repeat(obs, n, axis=0))
    pre = np.arctanh(extras["raw_action"].astype(np.float64)[:, 0]).reshape(
        2, n)
    assert np.all(np.abs(pre.mean(1) - mean) < 5 * std / math.sqrt(n))
    assert np.all(np.abs(pre.std(1) - std) < 5 * std / math.sqrt(2 * n))


def test_save_restore_keeps_the_reference_contract(tmp_path):
    """A checkpoint holds the policy's weights (the reference's layout)
    and no learner state: restoring gives the actor back, the critics
    stay as the restoring algorithm has them."""
    register_env("PendulumLite", lambda c: chip_smoke.PendulumLite(c))
    cfg = dict(env="PendulumLite", fcnet_hiddens=(16, 16), seed=0,
               device="cpu")
    algo = tsac.SACConfig().update(cfg).build()
    algo.save(str(tmp_path))
    other = tsac.SACConfig().update(dict(cfg, seed=5)).build()
    q1 = other.get_learner_state()["q1"]
    other.restore(str(tmp_path))
    for (_, x), (_, y) in zip(
            chip_smoke.rl_tree_paths(other.get_weights()["params"]),
            chip_smoke.rl_tree_paths(algo.get_weights()["params"])):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(other.get_learner_state()["q1"]["q_0"]["w"],
                                  q1["q_0"]["w"])


# ---------------------------------------------------------- offline data
def _episodes() -> "dict":
    """Two episodes in one batch: one terminated, one truncated with its
    final observation."""
    return {"obs": np.arange(10, dtype=np.float32).reshape(5, 2),
            "actions": np.array([0, 1, 1, 0, 1]),
            "rewards": np.array([1.0, 0.5, 2.0, -1.0, 0.25], np.float32),
            "new_obs": np.arange(2, 12, dtype=np.float32).reshape(5, 2),
            "terminateds": np.array([False, True, False, False, False]),
            "truncateds": np.array([False, False, False, False, True]),
            "eps_id": np.array([0, 0, 1, 1, 1])}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_json_dirs_read_the_same_in_both_packages(writer, tmp_path):
    w_mod, w_batch = (joffline, JSampleBatch) if writer == "jax" \
        else (offline, SampleBatch)
    w = w_mod.JsonWriter(str(tmp_path))
    w.write(w_batch(_episodes()))
    w.close()
    rows = list(offline.JsonReader(str(tmp_path)))
    assert rows == list(joffline.JsonReader(str(tmp_path)))
    assert [r["terminated"] for r in rows] == [True, False]
    assert rows[1]["final_obs"] == [10.0, 11.0]
    t = offline.OfflineData(str(tmp_path), gamma=0.9)
    j = joffline.OfflineData(str(tmp_path), gamma=0.9)
    for k in ("obs", "actions", "returns"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    assert (t.count, t.episodes) == (j.count, j.episodes) == (5, 2)
    value = lambda o: o.sum(-1)                      # noqa: E731
    t.rebuild_returns(value)
    j.rebuild_returns(value)
    np.testing.assert_array_equal(t.returns, j.returns)
    rng_t, rng_j = np.random.default_rng(4), np.random.default_rng(4)
    mt, mj = t.minibatch(rng_t, 3), j.minibatch(rng_j, 3)
    for k in mj:
        np.testing.assert_array_equal(mt[k], mj[k])


def test_rebuild_returns_bootstraps_a_truncated_episode(tmp_path):
    """tests/test_rllib_offline.py's case on the port: V(final_obs) seeds
    the truncated episode's returns only."""
    with open(tmp_path / "ep.json", "w") as f:
        f.write(json.dumps({"obs": [[0.0], [1.0]], "actions": [0, 1],
                            "rewards": [1.0, 1.0], "terminated": False,
                            "final_obs": [2.0]}) + "\n")
        f.write(json.dumps({"obs": [[3.0]], "actions": [0],
                            "rewards": [5.0], "terminated": True}) + "\n")
    data = offline.OfflineData(str(tmp_path), gamma=0.5)
    np.testing.assert_allclose(data.returns, [1.5, 1.0, 5.0])
    data.rebuild_returns(lambda obs: np.full(len(obs), 8.0))
    np.testing.assert_allclose(data.returns, [1.0 + 0.5 * (1.0 + 0.5 * 8),
                                              1.0 + 0.5 * 8, 5.0])


def test_record_rollouts_writes_what_the_reference_reads(tmp_path):
    env_cfg = {"obs_dim": 4, "num_actions": 2, "episode_len": 7}
    from ray_tpu_torch.rllib import env as tenv
    spaces = tenv.create_env("RandomEnv", env_cfg)
    pol = Policy(spaces.observation_space, spaces.action_space,
                 {"seed": 0, "device": "cpu", "fcnet_hiddens": (8, 8)})
    steps = offline.record_rollouts(pol, "RandomEnv", str(tmp_path),
                                    episodes=3, env_config=env_cfg,
                                    explore=False)
    j = joffline.OfflineData(str(tmp_path))
    assert steps == j.count == 21 and j.episodes == 3
    greedy, _ = pol.compute_actions(j.obs, explore=False)
    np.testing.assert_array_equal(j.actions, greedy)


# ------------------------------------------------------------ A3C, Ape-X
@pytest.mark.parametrize("size", ["mlp", "conv"])
def test_compute_gradients_matches_jax(size):
    """The worker step on a fixed fragment: the numpy gradient tree in the
    reference's layout, every leaf, the count and the stats."""
    run = f"a3c_{size}"
    cfg = chip_smoke.rl_config(run)
    jw = JRolloutWorker(cfg)
    tw = RolloutWorker(dict(cfg, device="cpu"))
    rng = np.random.default_rng(7)
    drawn = chip_smoke.rl_draw_tree(rng, [
        (p, v.shape) for p, v in chip_smoke.rl_tree_paths(
            jw.policy.get_weights())])
    frag = chip_smoke.rl_minibatches(run, rng)[0]
    jw.sample = lambda: JSampleBatch(dict(frag))
    tw.sample = lambda: SampleBatch(dict(frag))
    jg, jn, jinfo = jw.compute_gradients(drawn)
    tg, tn, tinfo = tw.compute_gradients(drawn)
    assert jn == tn == len(frag["obs"])
    got = dict(chip_smoke.rl_tree_paths(tg))
    for path, ref in chip_smoke.rl_tree_paths(jg):
        assert isinstance(got[path], np.ndarray)
        assert _err(got[path], ref) <= PARAM_TOL, path
    for k in jinfo:
        assert abs(tinfo[k] - jinfo[k]) <= OUT_TOL * max(abs(jinfo[k]), 1.0)


def test_prioritized_replay_gives_the_reference_indices_and_weights():
    n = 50
    rng = np.random.default_rng(0)
    batch = {"obs": rng.standard_normal((n, 3)).astype(np.float32),
             "actions": rng.integers(0, 2, n),
             "rewards": rng.standard_normal(n).astype(np.float32),
             "new_obs": rng.standard_normal((n, 3)).astype(np.float32),
             "terminateds": rng.uniform(size=n) < 0.1}
    t, j = tapex.PrioritizedReplay(64, 0.6, seed=3), \
        japex.PrioritizedReplay(64, 0.6, seed=3)
    for r in (t, j):
        assert r.add_batch(SampleBatch(dict(batch))) == n
    for step in range(3):
        (tc, ti, tw), (jc, ji, jw_) = t.sample(16, 0.4), j.sample(16, 0.4)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tw, jw_)
        for k in jc:
            np.testing.assert_array_equal(tc[k], jc[k])
        td = rng.standard_normal(16) * (step + 1)
        t.update_priorities(ti, td)
        j.update_priorities(ji, td)
        t.add_batch(SampleBatch(dict(batch)))     # wraps the ring
        j.add_batch(SampleBatch(dict(batch)))
    np.testing.assert_array_equal(t._prio, j._prio)
    assert t.size() == j.size() == 64
    assert tapex.apex_epsilons(5) == japex.apex_epsilons(5)


def test_apex_local_path_updates_priorities_and_syncs_the_target():
    algo = APEXConfig().update({
        "env": "RandomEnv", "num_workers": 0, "seed": 0, "device": "cpu",
        "rollout_fragment_length": 16, "learning_starts": 32,
        "train_batch_size": 8, "num_updates_per_iteration": 4,
        "target_network_update_freq": 6, "fcnet_hiddens": (8, 8)}).build()
    for _ in range(4):
        info = algo.train()["info"]
    assert info["learner_updates"] == 12 and algo.target_syncs == 2
    assert math.isfinite(info["mean_td_error"])
    assert (algo._local_replay._prio[:algo._local_replay.size()]
            != 1.0).any()
    assert algo.get_policy().epsilon < 1.0


# ----------------------------------------------------------- PendulumLite
def test_pendulum_lite_is_gymnasiums_pendulum():
    """Step for step from the same start: observations, rewards and flags
    equal, with torques beyond the bounds clipped the same way."""
    import gymnasium
    g = gymnasium.make("Pendulum-v1")
    p = chip_smoke.PendulumLite()
    assert p.observation_space.shape == g.observation_space.shape
    np.testing.assert_array_equal(p.observation_space.high,
                                  g.observation_space.high)
    np.testing.assert_array_equal(p.action_space.low, g.action_space.low)
    for seed in (0, 1):
        go, _ = g.reset(seed=seed)
        po, _ = p.reset(seed=seed)
        np.testing.assert_array_equal(po, go)
        rng = np.random.default_rng(seed)
        for t in range(200):
            u = rng.uniform(-2.5, 2.5, (1,)).astype(np.float32)
            gs, ps = g.step(u), p.step(u)
            np.testing.assert_array_equal(ps[0], gs[0])
            assert ps[1] == gs[1] and ps[2] == gs[2] and ps[3] == gs[3]
        assert ps[3] and not ps[2]
    g.close()
