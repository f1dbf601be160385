"""ray_tpu_torch.rllib's remote paths on the port's runtime, on the CPU.

The reference's remote RLlib tests (``tests/test_rllib.py``: PPO with
remote workers and a checkpoint, IMPALA with an MLP and a conv net,
Ape-X's replay-shard actors, the sync-sampling control;
``tests/test_tune_search_rllib2.py``: ES improves CartPole) with
``device="cpu"``, plus what the port adds: A3C's Hogwild at its default
``num_workers=2``, multi-agent PPO with a remote worker, PPO, DQN, SAC
and DDPG broadcasting to remote workers, rollout actors on the CPU, no
actor left after ``stop``, and a remote failure that raises.  Held
against the JAX package on the CPU: ES's flat parameter vector (bitwise),
its episode reward for one θ and one update's arithmetic; an IMPALA
update on a batch the remote workers sampled, within the learner
checks' limits (``chip_smoke.RL_PARAM_TOL`` on the params after it,
``RL_OUT_TOL`` on its statistics).

Every test shares one cluster of 4 CPUs; each test's actors are killed
after it.  Functions and classes here are pickled by value, so the
workers never import this module (nor JAX through it).
"""

import logging
import os
import sys
import time

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import ray_tpu
import ray_tpu_torch as rt
from ray_tpu.rllib import models as jm
from ray_tpu.rllib.algorithms import IMPALAConfig as JIMPALAConfig
from ray_tpu.rllib.algorithms import es as j_es
from ray_tpu_torch._private import rtlog
from ray_tpu_torch._private import worker as t_worker
from ray_tpu_torch.exceptions import RayActorError, RayTaskError
from ray_tpu_torch.rllib import (
    A3CConfig, APEXConfig, APPOConfig, DQNConfig, IMPALAConfig, PPOConfig,
    make_multi_agent, synchronous_parallel_sample)
from ray_tpu_torch.rllib import models as tm
from ray_tpu_torch.rllib.algorithms import DDPGConfig, ESConfig, SACConfig
from ray_tpu_torch.rllib.algorithms import es as t_es

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

CPU = dict(device="cpu")
_SMALL_CONV = [[16, 8, 4], [32, 4, 2]]


@pytest.fixture(scope="module")
def _cluster():
    """One cluster for the module; hands later test modules in this
    process the package logger as it was (``init`` stops its
    propagation)."""
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    rt.init(num_cpus=4)
    yield
    rt.shutdown()
    torch.set_num_threads(n)
    for h in log.handlers[:]:
        if h not in handlers:
            log.removeHandler(h)
            h.close()
    log.propagate, log.level = propagate, level
    rtlog._stream_configured = False
    rtlog._file_handlers.clear()


def _live_actors(wait_s: float = 0.0):
    """The cluster's actors not DEAD, polled for up to ``wait_s`` until
    there are none (a kill completes asynchronously)."""
    deadline = time.monotonic() + wait_s
    while True:
        live = [a for a in t_worker.global_worker().rpc("list_actors")
                ["actors"] if a["state"] != "DEAD"]
        if not live or time.monotonic() >= deadline:
            return live
        time.sleep(0.05)


@pytest.fixture
def cluster(_cluster):
    yield
    # actors of one test must not hold the cluster's CPUs into the next
    for a in _live_actors():
        rt.kill(rt.ActorHandle(a["actor_id"], {}))


def _remote_weights(algo):
    return rt.get([w.get_weights.remote()
                   for w in algo.workers.remote_workers])


def _assert_trees_equal(got, want):
    want = dict(chip_smoke.rl_tree_paths(want))
    got = dict(chip_smoke.rl_tree_paths(got))
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


# ------------------------------------------- the reference's remote tests
def test_ppo_remote_workers_and_checkpoint(cluster, tmp_path):
    """tests/test_rllib.py:152, and the restore reaches every remote."""
    algo = PPOConfig().environment("CartPole-v1").rollouts(
        num_workers=2, rollout_fragment_length=64).training(
        train_batch_size=128, sgd_minibatch_size=64,
        num_sgd_iter=2).resources(**CPU).debugging(seed=0).build()
    r = algo.train()
    assert r["training_iteration"] == 1
    assert r["timesteps_total"] >= 128
    ckpt = algo.save(str(tmp_path / "ck"))
    w_before = algo.get_weights()
    algo.train()
    algo.restore(ckpt)
    w_after = algo.get_weights()
    for k in w_before:
        np.testing.assert_array_equal(w_before[k]["w"], w_after[k]["w"])
    assert algo.iteration == 1
    for w in _remote_weights(algo):
        _assert_trees_equal(w, w_before)
    algo.stop()


def test_impala_smoke(cluster):
    """tests/test_rllib.py:171, at the reference's default num_workers=2:
    the async pipeline."""
    algo = IMPALAConfig().environment("CartPole-v1").rollouts(
        rollout_fragment_length=32, num_envs_per_worker=2).training(
        num_batches_per_iteration=4, lr=3e-4).resources(
        **CPU).debugging(seed=0).build()
    assert len(algo.workers.remote_workers) == 2
    for _ in range(3):
        r = algo.train()
    assert r["info"]["num_env_steps_trained"] >= 4 * 64
    assert np.isfinite(r["info"]["policy_loss"])
    # one fragment in flight per worker, keyed by the refs wait returned
    assert sorted(map(id, algo._in_flight.values())) == sorted(
        map(id, algo.workers.remote_workers))
    algo.stop()


def test_impala_conv_smoke(cluster):
    """tests/test_rllib.py:310."""
    algo = IMPALAConfig().environment(
        "RandomPixelEnv", env_config={"size": 36, "frames": 2}).rollouts(
        num_workers=2, rollout_fragment_length=16,
        num_envs_per_worker=2).training(
        num_batches_per_iteration=2, lr=3e-4, conv_filters=_SMALL_CONV,
        conv_dense=64).resources(**CPU).debugging(seed=0).build()
    for _ in range(2):
        r = algo.train()
    assert r["info"]["num_env_steps_trained"] >= 2 * 32
    assert np.isfinite(r["info"]["policy_loss"])
    algo.stop()


def test_apex_distributed_replay_actors(cluster):
    """tests/test_rllib.py:380: rollout workers stream to replay-shard
    actors, the learner pulls prioritized batches and pushes priorities
    back, and each worker keeps its own ladder epsilon across params-only
    broadcasts."""
    algo = APEXConfig().environment("CartPole-v1").rollouts(
        num_workers=2, rollout_fragment_length=16).training(
        learning_starts=96, train_batch_size=32, buffer_size=8192,
        num_updates_per_iteration=8, broadcast_interval=2,
        num_replay_shards=2).resources(**CPU).debugging(seed=0).build()
    total_updates = 0
    for _ in range(4):
        r = algo.train()
        total_updates = r["info"]["learner_updates"]
    assert total_updates > 0
    assert r["info"]["replay_shards"] == 2
    assert r["info"]["num_env_steps_sampled"] >= 96
    # ladder epsilons survived the broadcasts
    eps = [w["epsilon"] for w in _remote_weights(algo)]
    assert eps[0] != eps[1]
    # shards actually hold data and priorities moved
    sizes = rt.get([s.size.remote() for s in algo.replay_shards])
    assert all(sz > 0 for sz in sizes)
    algo.stop()
    assert algo.replay_shards == [] and not _live_actors(wait_s=10)


def test_impala_sync_sampling_control(cluster):
    """tests/test_rllib.py:409: the barrier-mode control used by the
    overlap benchmark."""
    algo = (IMPALAConfig().environment("CartPole-v1")
            .rollouts(num_workers=1, num_envs_per_worker=2,
                      rollout_fragment_length=16)
            .training(num_batches_per_iteration=2, sync_sampling=True)
            .resources(**CPU).debugging(seed=0).build())
    r = algo.train()
    assert r["info"]["num_env_steps_trained"] >= 32
    assert not algo._in_flight
    algo.stop()


def test_es_improves_cartpole(cluster):
    """tests/test_tune_search_rllib2.py:140: the episodes are tasks."""
    algo = (ESConfig().environment("CartPole-v1")
            .training(episodes_per_batch=8, noise_std=0.5, step_size=0.2,
                      fcnet_hiddens=(16,))
            .resources(**CPU).debugging(seed=3)
            .build())
    rewards = [algo.train()["episode_reward_mean"] for _ in range(12)]
    # derivative-free optimization is noisy; require clear improvement
    assert max(rewards[4:]) > rewards[0] + 10, rewards
    assert np.isfinite(algo.evaluate(episodes=2)["evaluation_reward_mean"])


# ------------------------------------------------ the port's remote paths
@pytest.mark.parametrize("cls", [A3CConfig, APPOConfig])
def test_default_two_workers_build_and_train(cluster, cls):
    """A3C's Hogwild and APPO's async path at the reference's default
    num_workers=2: the learner's params move, one call in flight a
    worker."""
    algo = cls().environment("CartPole-v1").rollouts(
        rollout_fragment_length=16).training(
        grads_per_iteration=4, num_batches_per_iteration=4).resources(
        **CPU).debugging(seed=0).build()
    assert len(algo.workers.remote_workers) == 2
    before = algo.get_weights()
    info = algo.train()["info"]
    assert info["num_env_steps_trained"] >= 4 * 16
    assert all(np.isfinite(v) for v in info.values())
    assert len(algo._in_flight) == 2
    moved = chip_smoke.rl_update_norm(before, algo.get_weights())
    assert moved > 0
    algo.stop()


def test_multi_agent_ppo_with_a_remote_worker(cluster):
    algo = PPOConfig().environment(
        make_multi_agent("RandomEnv"), env_config={"num_agents": 2}
    ).rollouts(num_workers=1, rollout_fragment_length=16).training(
        train_batch_size=16, sgd_minibatch_size=8, num_sgd_iter=2,
        fcnet_hiddens=(16,)).resources(**CPU).debugging(seed=0).multi_agent(
        policies={"p0", "p1"},
        policy_mapping_fn=lambda aid: "p0" if aid == "agent_0" else "p1",
    ).build()
    r = algo.train()
    assert {"p0", "p1"} <= set(r["info"])
    assert np.isfinite(r["info"]["p0"]["kl"])
    (remote,) = _remote_weights(algo)
    assert set(remote) == {"p0", "p1"}
    _assert_trees_equal(remote, algo.get_weights())
    algo.stop()


OFF_POLICY = {
    "dqn": (DQNConfig, "CartPole-v1",
            dict(learning_starts=16, train_batch_size=16,
                 rollout_fragment_length=8)),
    "sac": (SACConfig, "Pendulum-v1",
            dict(learning_starts=16, train_batch_size=16,
                 rollout_fragment_length=8, fcnet_hiddens=(16, 16))),
    "ddpg": (DDPGConfig, "Pendulum-v1",
             dict(learning_starts=16, train_batch_size=16,
                  rollout_fragment_length=8, fcnet_hiddens=(16, 16))),
}


@pytest.mark.parametrize("name", list(OFF_POLICY))
def test_synchronous_algorithms_broadcast_to_remote_workers(cluster, name):
    """DQN, SAC and DDPG sample through the remote workers and end
    each learning step with a broadcast: every remote holds the
    learner's params bitwise."""
    cls, env, kw = OFF_POLICY[name]
    algo = cls().environment(env).rollouts(num_workers=2).training(
        **kw).resources(**CPU).debugging(seed=0).build()
    for _ in range(3):
        r = algo.train()
    assert r["timesteps_total"] >= 3 * 2 * 8
    assert r["info"]["buffer_size"] == r["timesteps_total"]
    want = algo.get_weights()["params"]
    for w in _remote_weights(algo):
        _assert_trees_equal(w["params"], want)
    algo.stop()


def test_rollout_actors_run_on_the_cpu(cluster):
    """Each remote worker's policy is on the CPU in a process that sees
    no card, whatever the learner's device; weights equal after a sync."""
    algo = IMPALAConfig().environment("CartPole-v1").rollouts(
        rollout_fragment_length=8).training(
        num_batches_per_iteration=1, fcnet_hiddens=(8,)).resources(
        **CPU).debugging(seed=0).build()
    info = rt.get([w.__ray_call__.remote(lambda self: (
        self.policy.device.type, self.config["device"],
        os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()))
        for w in algo.workers.remote_workers])
    assert [i[:3] for i in info] == [("cpu", "cpu", "")] * 2
    assert os.getpid() not in [i[3] for i in info]
    assert algo.config["device"] == "cpu"
    algo.train()
    algo.workers.sync_weights()
    for w in _remote_weights(algo):
        _assert_trees_equal(w, algo.get_weights())
    algo.stop()
    assert algo.workers.remote_workers == [] and not _live_actors(
        wait_s=10)


class _FailsOffTheDriver:
    """CartPole-shaped env whose step raises in any process but the one
    that built the config."""

    def __init__(self, cfg):
        from ray_tpu_torch.rllib.env import RandomEnv
        self._inner = RandomEnv({"obs_dim": 4, "num_actions": 2})
        self._pid = cfg["driver_pid"]
        self.observation_space = self._inner.observation_space
        self.action_space = self._inner.action_space

    def reset(self, seed=None):
        return self._inner.reset(seed=seed)

    def step(self, action):
        if os.getpid() != self._pid:
            raise RuntimeError("env step failed on a rollout worker")
        return self._inner.step(action)


@pytest.mark.parametrize("cls", [PPOConfig, IMPALAConfig])
def test_a_failing_remote_worker_raises(cluster, cls):
    """No fallback: sampling does not move to the local worker when the
    remotes fail."""
    algo = cls().environment(_FailsOffTheDriver, env_config={
        "driver_pid": os.getpid()}).rollouts(
        num_workers=1, rollout_fragment_length=8).training(
        train_batch_size=8, sgd_minibatch_size=8, num_sgd_iter=1,
        num_batches_per_iteration=1).resources(**CPU).build()
    with pytest.raises((RayTaskError, RayActorError),
                       match="failed on a rollout worker"):
        algo.train()
    algo.stop()


# ------------------------------------------------ against the JAX package
def _es_configs(hiddens=(16,)):
    kw = dict(obs_dim=4, num_outputs=2, hiddens=hiddens)
    return jm.ModelConfig(**kw), tm.ModelConfig(**kw)


@pytest.mark.parametrize("hiddens", [(16,), (8, 8)])
def test_es_flat_vector_is_the_references(hiddens):
    """One θ means the same network in both packages: the port's
    ``_flatten`` of JAX's params carried by the weight bridge equals JAX's
    ``_flatten`` bitwise, and ``_unflatten`` gives the leaves back."""
    jcfg, tcfg = _es_configs(hiddens)
    jparams = jm.init_q_net(jax.random.key(7), jcfg)
    tparams = tm.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                   "cpu")
    flat = t_es._flatten(tparams)
    want = j_es._flatten(jparams)
    assert flat.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(flat, want)
    back = t_es._unflatten(flat, tparams)
    _assert_trees_equal(tm.params_to_numpy(back),
                        tm.params_to_numpy(tparams))


def test_es_rollout_reward_is_the_references():
    """The port's episode for a flat θ earns JAX's reward on the same env
    seed (greedy CartPole episodes, θ perturbed as ES does)."""
    jcfg, tcfg = _es_configs()
    theta = j_es._flatten(jm.init_q_net(jax.random.key(3), jcfg))
    rng = np.random.default_rng(0)
    for seed in (10_001, 10_002, 10_003):
        th = (theta + 0.5 * rng.standard_normal(theta.shape)).astype(
            np.float32)
        got = t_es._es_rollout._function(
            "CartPole-v1", {}, tcfg.__dict__, th, seed, device="cpu")
        want = j_es._es_rollout._function(
            "CartPole-v1", {}, jcfg.__dict__, th, seed)
        assert got == want, (seed, got, want)


class _Rewards:
    """An ``_es_rollout`` stand-in: a fixed linear fitness of θ, so both
    packages' updates see the same rewards."""

    def __init__(self, dim, put):
        self.w = np.random.default_rng(5).standard_normal(dim)
        self.put = put

    def remote(self, env, env_config, mc, theta, seed, device="cpu"):
        return self.put(float(theta @ self.w))


def test_es_update_is_the_references(cluster, monkeypatch):
    """One ES update of the port equals the JAX package's (es.py:87-117:
    noise, antithetic rank-normalized step) on the same θ, generator and
    rewards, bitwise."""
    t_algo = ESConfig().environment("CartPole-v1").training(
        episodes_per_batch=6, fcnet_hiddens=(8,)).resources(
        **CPU).debugging(seed=2).build()
    j_algo = j_es.ESConfig().environment("CartPole-v1").training(
        episodes_per_batch=6, fcnet_hiddens=(8,)).debugging(seed=2).build()
    assert j_algo.theta.shape == t_algo.theta.shape
    j_algo.theta = t_algo.theta.copy()
    dim = len(t_algo.theta)
    monkeypatch.setattr(t_es, "_es_rollout", _Rewards(dim, rt.put))
    monkeypatch.setattr(j_es, "_es_rollout", _Rewards(dim, lambda v: v))
    monkeypatch.setattr(ray_tpu, "get", lambda refs: refs)
    for _ in range(2):
        got = t_algo.training_step()
        want = j_algo.training_step()
        np.testing.assert_array_equal(t_algo.theta, j_algo.theta)
        assert got == want


def test_impala_update_on_a_remote_batch_matches_jax(cluster):
    """A batch the remote workers sampled (sync-sampling mode) through the
    port's learner and the JAX learner from the same weights: params
    after the update within RL_PARAM_TOL of their largest magnitude, the
    statistics within RL_OUT_TOL."""
    cfg = dict(env="CartPole-v1", num_envs_per_worker=2,
               rollout_fragment_length=16, fcnet_hiddens=(16, 16),
               num_batches_per_iteration=1, sync_sampling=True, seed=0)
    algo = IMPALAConfig().update(dict(cfg, device="cpu")).build()
    batch = synchronous_parallel_sample(algo.workers)
    assert batch.count == 2 * 2 * 16
    j_algo = JIMPALAConfig().update(dict(cfg, num_workers=0)).build()
    before = algo.get_weights()
    params, _, info = j_algo._update(
        jax.tree.map(jnp.asarray, before), j_algo._opt_state,
        j_algo._to_time_major(batch))
    stats = algo._learn_on(batch).tolist()
    want = dict(chip_smoke.rl_tree_paths(jax.tree.map(np.asarray, params)))
    got = dict(chip_smoke.rl_tree_paths(algo.get_weights()))
    for k, v in want.items():
        err = np.abs(got[k] - v).max() / max(np.abs(v).max(), 1e-30)
        assert err <= chip_smoke.RL_PARAM_TOL, (k, err)
    assert chip_smoke.rl_update_norm(before, got) > 0
    for name, s in zip(("policy_loss", "vf_loss", "entropy"), stats):
        ref = float(info[name])
        assert abs(s - ref) <= chip_smoke.RL_OUT_TOL * max(abs(ref), 1e-30)
    # the next iteration broadcasts first: the remotes get these weights
    algo.train()
    algo.stop()


# ------------------------------------------ chip_smoke's remote phases
def test_cartpole_lite_is_gymnasiums_cartpole():
    """chip_smoke's CartPole (the card's machine has no gymnasium) step
    for step against CartPole-v1 from the same seeds: observations,
    rewards and flags equal, through termination and the 500-step
    truncation."""
    import gymnasium
    g = gymnasium.make("CartPole-v1")
    p = chip_smoke.CartPoleLite()
    np.testing.assert_array_equal(p.observation_space.high,
                                  g.observation_space.high)
    assert p.action_space.n == g.action_space.n
    for seed in (0, 1, 2):
        go, _ = g.reset(seed=seed)
        po, _ = p.reset(seed=seed)
        np.testing.assert_array_equal(po, go)
        rng = np.random.default_rng(seed)
        # seed 2 balances the pole by a hand rule until the time limit
        policy = (lambda o: int(o[2] + 0.5 * o[3] > 0)) if seed == 2 \
            else (lambda o: int(rng.integers(2)))
        o, done = po, False
        while not done:
            a = policy(o)
            gs, ps = g.step(a), p.step(a)
            np.testing.assert_array_equal(ps[0], gs[0])
            assert ps[1:4] == gs[1:4]
            o, done = ps[0], ps[2] or ps[3]
        if seed == 2:
            assert ps[3] and not ps[2] and p._t == 500
    g.close()


class _Fail(Exception):
    pass


def test_chip_checks_of_the_remote_fleet(cluster, monkeypatch):
    """chip_smoke's checks of the remote phases on a small IMPALA fleet:
    the remotes' weights bitwise the learner's after a sync (one remote
    given other weights must fail it), every rollout worker a CPU
    process, and no actor or process left after stop()."""
    def fail(msg):
        raise _Fail(msg)

    monkeypatch.setattr(chip_smoke, "fail", fail)
    algo = IMPALAConfig().environment(chip_smoke.CartPoleLite).rollouts(
        rollout_fragment_length=8).training(
        num_batches_per_iteration=2, fcnet_hiddens=(8,)).resources(
        **CPU).debugging(seed=0).build()
    devices = chip_smoke.remote_devices(algo)
    assert [d[1:] for d in devices] == [("cpu", "cpu", "", False)] * 2
    algo.train()
    algo.workers.sync_weights()
    chip_smoke.check_remote_weights(algo, "test", "cpu")
    w = algo.get_weights()
    w["pi_out"]["b"] = w["pi_out"]["b"] + np.float32(1e-6)
    rt.get(algo.workers.remote_workers[1].set_weights.remote(w))
    with pytest.raises(_Fail, match="remote weights differ"):
        chip_smoke.check_remote_weights(algo, "test", "cpu")
    chip_smoke.stop_and_check(algo, "test", "cpu")
    assert not _live_actors()
