"""ray_tpu_torch.rllib held against ray_tpu.rllib on the CPU.

Weights are drawn with numpy in the reference's layout
(``chip_smoke.rl_draw_tree``) or taken from a JAX policy, and cross by
the weight bridge (``models.params_from_numpy``); observations and
batches are made with numpy from a seed.  Both sides run in float32.

Tolerances, each with its reason: float32 on both sides with sums in
other orders.  Network outputs, distribution values and V-trace to 1e-5
of their largest magnitude (the largest error seen is under 1e-6);
optimizer updates over 3 steps to 1e-6 relative (elementwise arithmetic,
rsqrt against 1/sqrt).  The learners: one update of each, on the same
draws as ``tests/data/rllib_reference.json`` (the JAX learners' outputs,
regenerated and required equal in ``tests/test_torch_rllib_reference.py``)
within ``chip_smoke``'s limits: params after the update 1e-5 of their
largest magnitude, statistics and norms 1e-4 (CPU: at most 1e-6).
Sampling cannot match JAX's bits, so it is held by distribution: a χ²
test on fixed logits (p > 0.001 at a fixed seed) and the mean and std of
Gaussian draws within 5 standard errors.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from ray_tpu.rllib import models as jm
from ray_tpu.rllib import vtrace as jvtrace
from ray_tpu.rllib.algorithms import PPOConfig as JPPOConfig
from ray_tpu_torch.parallel import transforms as tx
from ray_tpu_torch.rllib import (
    APPOConfig, DQNConfig, IMPALAConfig, PPOConfig, Policy, RolloutWorker,
    SampleBatch, make_multi_agent, vtrace)
from ray_tpu_torch.rllib import env as tenv
from ray_tpu_torch.rllib import models as tm
from ray_tpu_torch.rllib.algorithms import ppo as tppo
from ray_tpu_torch.rllib.algorithms.dqn import DQNPolicy
from ray_tpu_torch.rllib.sample_batch import (
    ACTION_DIST_INPUTS, ACTION_LOGP, ACTIONS, ADVANTAGES, EPS_ID, NEXT_OBS,
    OBS, REWARDS, TERMINATEDS, TRUNCATEDS, VALUE_TARGETS, VF_PREDS)

CPU = torch.device("cpu")
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol=TOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


# ------------------------------------------------------------ networks
NETS = {
    "mlp": dict(obs_shape=(4,), num_outputs=2, hiddens=(16, 16)),
    "conv": dict(obs_shape=(36, 36, 2), num_outputs=4,
                 conv_filters=((16, 8, 4), (32, 4, 2)), conv_dense=64),
    "nature": dict(obs_shape=(84, 84, 4), num_outputs=6,
                   conv_filters=jm.NATURE_CNN_FILTERS, conv_dense=512),
}


def _model_cfgs(name):
    kw = dict(NETS[name])
    kw["obs_dim"] = int(np.prod(kw["obs_shape"]))
    if "conv_filters" not in kw:
        kw["obs_shape"] = ()
    return jm.ModelConfig(**kw), tm.ModelConfig(**kw)


def _obs(name, rng, n):
    shape = NETS[name]["obs_shape"]
    if len(shape) == 1:
        return rng.standard_normal((n,) + shape).astype(np.float32)
    return rng.integers(0, 256, (n,) + shape, dtype=np.uint8)


def _applies(name, head):
    """(JAX apply, port apply) of one catalog network."""
    jcfg, tcfg = _model_cfgs(name)
    n = len(jcfg.hiddens)
    if head == "q":
        if jcfg.conv_filters:
            return (lambda p, o: jm.q_net_conv_apply(p, o, jcfg),
                    lambda p, o: tm.q_net_conv_apply(p, o, tcfg))
        return (lambda p, o: jm.q_net_apply(p, o, n + 1),
                lambda p, o: tm.q_net_apply(p, o, n + 1))
    if jcfg.conv_filters:
        return (lambda p, o: jm.actor_critic_conv_apply(p, o, jcfg),
                lambda p, o: tm.actor_critic_conv_apply(p, o, tcfg))
    return (lambda p, o: jm.actor_critic_apply(p, o, n),
            lambda p, o: tm.actor_critic_apply(p, o, n))


def _drawn(name, head, seed=0):
    """Weights drawn in the reference's layout, with the shapes of its
    init (traced, not run)."""
    jcfg, _ = _model_cfgs(name)
    make_j = jm.make_q_net if head == "q" else jm.make_actor_critic
    shapes = jax.eval_shape(lambda: make_j(jax.random.key(0), jcfg)[0])
    leaves = [("/".join(str(k.key) for k in path), leaf.shape) for path, leaf
              in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    return chip_smoke.rl_draw_tree(np.random.default_rng(seed), leaves)


def _nets(name, head, seed=0):
    """(drawn numpy params, JAX apply (jitted), port apply, port
    params)."""
    drawn = _drawn(name, head, seed)
    japply, tapply = _applies(name, head)
    return drawn, jax.jit(japply), tapply, \
        tm.params_from_numpy(drawn, _model_cfgs(name)[1], CPU)


@pytest.mark.parametrize("name,head", [
    ("mlp", "ac"), ("conv", "ac"), ("nature", "ac"), ("mlp", "q"),
    ("conv", "q"), ("nature", "q")])
def test_apply_matches_jax(name, head):
    """Both heads of the actor-critic (dist inputs and values) and the
    Q-nets, the MLP and the conv torso, the Nature CNN at Atari's
    84×84×4: port against JAX on the same drawn weights and frames."""
    drawn, japply, tapply, tparams = _nets(name, head)
    obs = _obs(name, np.random.default_rng(1), 5)
    ref = japply(jax.tree.map(jnp.asarray, drawn), jnp.asarray(obs))
    with torch.no_grad():
        got = tapply(tparams, torch.from_numpy(obs))
    for g, r in zip(*(((got,), (ref,)) if head == "q" else (got, ref))):
        _close(g.numpy(), np.asarray(r))


def test_flatten_order_control(monkeypatch):
    """The torso flattened in (C, H, W) order, PyTorch's, is far from the
    reference's (H, W, C): the apply test catches it."""
    drawn, japply, tapply, tparams = _nets("conv", "ac")
    obs = _obs("conv", np.random.default_rng(1), 5)
    ref = np.asarray(japply(jax.tree.map(jnp.asarray, drawn),
                            jnp.asarray(obs))[0])
    monkeypatch.setattr(tm, "_flatten_hwc",
                        chip_smoke._rl_flatten_nchw(tm._flatten_hwc))
    with torch.no_grad():
        got = tapply(tparams, torch.from_numpy(obs))[0].numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() > 1e-2


@pytest.mark.parametrize("name,head", [("mlp", "ac"), ("conv", "ac"),
                                       ("conv", "q")])
def test_weights_round_trip(name, head):
    """The reference's layout in, the same numpy dict out, bitwise; conv
    kernels ride as (O, I, H, W) channels-last."""
    tcfg = _model_cfgs(name)[1]
    tree = _drawn(name, head, seed=3)
    back = tm.params_to_numpy(tm.params_from_numpy(tree, tcfg, CPU))
    flat_in = dict(chip_smoke.rl_tree_paths(tree))
    flat_out = dict(chip_smoke.rl_tree_paths(back))
    assert flat_in.keys() == flat_out.keys()
    for k in flat_in:
        np.testing.assert_array_equal(flat_out[k], flat_in[k], err_msg=k)
    if name == "conv":
        w = tm.params_from_numpy(tree, tcfg, CPU)["torso"]["conv_0"]["w"]
        assert w.shape == (16, 2, 8, 8)
        assert w.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="conv"):
        tm.params_from_numpy(tree, _model_cfgs(
            "mlp" if name == "conv" else "conv")[1], CPU)


def test_policy_weights_round_trip_through_jax_policy():
    """``set_weights(jax_policy.get_weights())`` then ``get_weights()``
    gives the numpy dict that went in; the two policies act alike."""
    from ray_tpu.rllib import Policy as JPolicy
    obs_sp = tenv.make_box(0, 255, (36, 36, 2), np.uint8)
    act_sp = tenv.make_discrete(4)
    cfg = {"conv_filters": ((16, 8, 4), (32, 4, 2)), "conv_dense": 64,
           "seed": 5}
    jp = JPolicy(obs_sp, act_sp, cfg)
    tp = Policy(obs_sp, act_sp, {**cfg, "device": "cpu"})
    w = jp.get_weights()
    tp.set_weights(w)
    back = tp.get_weights()
    for k, v in chip_smoke.rl_tree_paths(w):
        np.testing.assert_array_equal(dict(chip_smoke.rl_tree_paths(back))[k],
                                      v, err_msg=k)
    obs = _obs("conv", np.random.default_rng(2), 3)
    a_j, ex_j = jp.compute_actions(obs, explore=False)
    a_t, ex_t = tp.compute_actions(obs, explore=False)
    np.testing.assert_array_equal(a_t, a_j)
    _close(ex_t[ACTION_DIST_INPUTS], ex_j[ACTION_DIST_INPUTS])
    _close(ex_t[VF_PREDS], ex_j[VF_PREDS])
    _close(tp.value(obs), jp.value(obs))


def test_compute_actions_one_call_outputs_agree():
    """Explore: the logp returned is the dist's logp of the returned
    action under the returned inputs, values equal ``value``; a uint8
    frame gives the values of the same frame in float32."""
    obs_sp = tenv.make_box(0, 255, (36, 36, 2), np.uint8)
    pol = Policy(obs_sp, tenv.make_discrete(4), {
        "conv_filters": ((16, 8, 4), (32, 4, 2)), "conv_dense": 64,
        "device": "cpu"})
    obs = _obs("conv", np.random.default_rng(4), 6)
    acts, ex = pol.compute_actions(obs)
    assert acts.shape == (6,) and acts.dtype == np.int32
    logp = tm.Categorical.logp(torch.from_numpy(ex[ACTION_DIST_INPUTS]),
                               torch.from_numpy(acts)).numpy()
    _close(ex[ACTION_LOGP], logp)
    _close(ex[VF_PREDS], pol.value(obs))
    _close(pol.value(obs.astype(np.float32)), pol.value(obs))


# -------------------------------------------------------- distributions
@pytest.mark.parametrize("dist", ["categorical", "gaussian"])
def test_dist_values_match_jax(dist):
    rng = np.random.default_rng(7)
    jd, td = ((jm.Categorical, tm.Categorical) if dist == "categorical"
              else (jm.DiagGaussian, tm.DiagGaussian))
    p = rng.standard_normal((9, 6)).astype(np.float32) * 2
    q = rng.standard_normal((9, 6)).astype(np.float32) * 2
    if dist == "categorical":
        acts = rng.integers(0, 6, 9).astype(np.int32)
    else:
        p[:, 3:] = np.clip(p[:, 3:], -3, 1)     # log stds
        q[:, 3:] = np.clip(q[:, 3:], -3, 1)
        acts = rng.standard_normal((9, 3)).astype(np.float32)
    P, Q, A = (torch.from_numpy(x) for x in (p, q, acts))
    _close(td.logp(P, A).numpy(), jd.logp(jnp.asarray(p), jnp.asarray(acts)))
    _close(td.entropy(P).numpy(), jd.entropy(jnp.asarray(p)))
    _close(td.kl(P, Q).numpy(), jd.kl(jnp.asarray(p), jnp.asarray(q)))
    _close(td.deterministic(P).numpy(), jd.deterministic(jnp.asarray(p)))


def test_categorical_sampling_by_distribution():
    """χ² over 40,000 draws of fixed logits (Gumbel-max, as
    ``jax.random.categorical``), at a fixed seed."""
    from scipy import stats
    logits = torch.tensor([0.5, -1.0, 2.0, 0.0, -3.0])
    n = 40_000
    gen = torch.Generator().manual_seed(0)
    draws = tm.Categorical.sample(logits.expand(n, 5), gen)
    counts = np.bincount(draws.numpy(), minlength=5)
    probs = torch.softmax(logits.double(), 0).numpy()
    expect = probs / probs.sum() * counts.sum()
    p = stats.chisquare(counts, expect).pvalue
    assert p > 1e-3, (counts, expect, p)
    # and a wrong distribution is rejected by the same test
    assert stats.chisquare(counts, np.full(5, n / 5)).pvalue < 1e-3


def test_gaussian_sampling_by_distribution():
    mean = torch.tensor([0.5, -2.0])
    log_std = torch.tensor([0.0, -1.5])
    n = 40_000
    inputs = torch.cat([mean, log_std]).expand(n, 4)
    x = tm.DiagGaussian.sample(inputs, torch.Generator().manual_seed(0))
    std = torch.exp(log_std)
    assert torch.all((x.mean(0) - mean).abs() < 5 * std / n ** 0.5)
    assert torch.all((x.std(0) - std).abs() < 5 * std / (2 * n) ** 0.5)


# -------------------------------------------------------------- V-trace
@pytest.mark.parametrize("T,B,seed", [(1, 3, 0), (9, 4, 1), (33, 16, 2)])
def test_vtrace_matches_jax(T, B, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    args = dict(behavior_logp=f(T, B) * 0.5 - 1, target_logp=f(T, B) * 0.5
                - 1, rewards=f(T, B),
                discounts=(0.97 * (rng.uniform(size=(T, B)) > 0.3)).astype(
                    np.float32),
                values=f(T, B), bootstrap_value=f(B))
    clips = dict(clip_rho=1.0, clip_c=0.9, clip_pg_rho=1.3)
    j = jvtrace(**{k: jnp.asarray(v) for k, v in args.items()}, **clips)
    t = vtrace(**{k: torch.from_numpy(v) for k, v in args.items()}, **clips)
    for g, r in zip(t, j):
        _close(g.numpy(), np.asarray(r))


# ------------------------------------------------------------ optimizers
OPTS = {
    "scale_by_rms": (lambda: tx.scale_by_rms(0.99, 0.1),
                     lambda: optax.scale_by_rms(0.99, 0.1)),
    "rmsprop": (lambda: tx.chain(tx.clip_by_global_norm(40.0),
                                 tx.rmsprop(5e-4, decay=0.99, eps=0.1)),
                lambda: optax.chain(optax.clip_by_global_norm(40.0),
                                    optax.rmsprop(5e-4, decay=0.99,
                                                  eps=0.1))),
    "adam": (lambda: tx.chain(tx.clip_by_global_norm(0.5), tx.adam(3e-4)),
             lambda: optax.chain(optax.clip_by_global_norm(0.5),
                                 optax.adam(3e-4))),
}


@pytest.mark.parametrize("name", list(OPTS))
def test_transforms_match_optax(name):
    """Three steps of each on a two-leaf tree, the gradients spread over
    six decades so that eps's placement and the clip both matter."""
    rng = np.random.default_rng(11)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    grads = [{"a": (rng.standard_normal((4, 3))
                    * 10.0 ** rng.uniform(-4, 2, (4, 3))).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
             for _ in range(3)]
    t_make, j_make = OPTS[name]
    t_opt, j_opt = t_make(), j_make()
    tp = tx.tree_map(torch.from_numpy, params)
    jp = jax.tree.map(jnp.asarray, params)
    t_state, j_state = t_opt.init(tp), j_opt.init(jp)
    for g in grads:
        tu, t_state = t_opt.update(tx.tree_map(torch.from_numpy, g),
                                   t_state, tp)
        ju, j_state = j_opt.update(jax.tree.map(jnp.asarray, g), j_state,
                                   jp)
        for (path, t_leaf), j_leaf in zip(tx.tree_leaves_with_path(tu),
                                          jax.tree.leaves(ju)):
            _close(t_leaf.numpy(), np.asarray(j_leaf), 1e-6)


def test_rmsprop_eps_outside_root_is_caught():
    """torch.optim.RMSprop's placement of eps (outside the root) is far
    from optax's at eps 0.1."""
    g = {"a": torch.full((3,), 0.05)}
    good = tx.scale_by_rms(0.99, 0.1)
    bad = chip_smoke._rl_rms_eps_outside_root(None)(0.99, 0.1)
    u_good, _ = good.update(g, good.init(g))
    u_bad, _ = bad.update(g, bad.init(g))
    assert (u_bad["a"] / u_good["a"]).min() > 2.5


# -------------------------------------------------------------- learners
@pytest.fixture(scope="module")
def reference():
    with open(chip_smoke.RL_REFERENCE) as f:
        return json.load(f)["runs"]


@pytest.mark.parametrize("run", chip_smoke.RL_RUNS)
def test_learner_update_matches_jax(run, reference):
    """One update of PPO (two epochs of one full-batch minibatch), IMPALA,
    APPO, DQN (double_q on and off), and V-trace, at the MLP and conv
    sizes, against the JAX learners' outputs on the same draws."""
    ratio, worst, errs = chip_smoke.rl_errors(run, reference[run], CPU)
    assert ratio <= 1.0, (worst, errs)
    # CPU float32 on both sides: well inside the card's limits
    assert ratio <= 0.05, (worst, errs)


@pytest.mark.parametrize("fault,run", [
    ("conv_flatten_nchw", "ppo_conv"),
    ("conv_flatten_nchw", "dqn_double_conv"),
    ("rmsprop_eps_outside_root", "impala_mlp"),
    ("rmsprop_eps_outside_root", "appo_conv"),
    ("ppo_unbiased_std", "ppo_mlp"), ("ppo_unbiased_std", "ppo_conv")])
def test_planted_fault_fails_the_learner_check(fault, run, reference,
                                               monkeypatch):
    import importlib
    module, attr, plant = chip_smoke.RL_FAULTS[fault]
    mod = importlib.import_module(f"ray_tpu_torch.{module}")
    monkeypatch.setattr(mod, attr, plant(getattr(mod, attr)))
    ratio, worst, _ = chip_smoke.rl_errors(run, reference[run], CPU)
    assert ratio > 1.0, (fault, run, worst, ratio)


def test_ppo_advantages_use_the_population_std():
    adv = torch.tensor([1.0, 2.0, 4.0, 7.0])
    out = tppo.normalize_advantages(adv)
    ref = (np.asarray(adv) - 3.5) / (np.std(np.asarray(adv)) + 1e-8)
    _close(out.numpy(), ref, 1e-6)


# --------------------------------------------------------- rollouts etc.
def test_rollout_worker_sample_shapes():
    w = RolloutWorker({"env": "RandomEnv", "env_config": {
        "obs_dim": 3, "episode_len": 7}, "num_envs_per_worker": 3,
        "rollout_fragment_length": 10, "seed": 1, "device": "cpu",
        "fcnet_hiddens": (8,)})
    b = w.sample()
    assert isinstance(b, SampleBatch) and b.count == 30
    assert b[OBS].shape == (30, 3) and b[OBS].dtype == np.float32
    assert b[NEXT_OBS].shape == (30, 3)
    assert b[ACTIONS].shape == (30,)
    assert b[ACTION_DIST_INPUTS].shape == (30, 2)
    for k in (REWARDS, TERMINATEDS, TRUNCATEDS, EPS_ID, ACTION_LOGP,
              VF_PREDS, ADVANTAGES, VALUE_TARGETS):
        assert b[k].shape == (30,), k
    m = w.get_metrics()
    assert m["num_env_steps"] == 30
    assert m["episode_lens"] == [7] * 3           # 3 envs × 1 episode
    assert w.get_spaces()[0].shape == (3,)


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = tenv.RandomEnv()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Policy(env.observation_space, env.action_space, {"seed": 0})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DQNPolicy(env.observation_space, env.action_space, {"seed": 0})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PPOConfig().environment("RandomEnv").build()
    pol = Policy(env.observation_space, env.action_space,
                 {"seed": 0, "device": "cpu"})
    assert pol.params["pi_0"]["w"].device.type == "cpu"


def test_save_restore_in_the_reference_layout(tmp_path):
    """A checkpoint holds numpy weights in the reference's layout: the
    port restores its own, and the JAX package restores it too."""
    cfg = dict(env="RandomEnv", num_workers=0, rollout_fragment_length=32,
               train_batch_size=32, sgd_minibatch_size=16, num_sgd_iter=2,
               fcnet_hiddens=(8, 8), seed=3)
    algo = PPOConfig().update(dict(cfg, device="cpu")).build()
    algo.train()
    algo._learners["default_policy"]["kl_coeff"] = 0.123
    ckpt = algo.save(str(tmp_path / "ck"))
    with open(tmp_path / "ck" / "algorithm_state.pkl", "rb") as f:
        state = pickle.load(f)
    assert state["weights"]["pi_0"]["w"].shape == (4, 8)
    assert isinstance(state["weights"]["pi_0"]["w"], np.ndarray)
    fresh = PPOConfig().update(dict(cfg, device="cpu", seed=9)).build()
    fresh.restore(ckpt)
    assert fresh.iteration == 1
    assert fresh._learners["default_policy"]["kl_coeff"] == 0.123
    jalgo = JPPOConfig().update(cfg).build()
    jalgo.restore(ckpt)
    want = dict(chip_smoke.rl_tree_paths(algo.get_weights()))
    for got in (fresh.get_weights(), jalgo.get_weights()):
        for k, v in chip_smoke.rl_tree_paths(got):
            np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=k)


def test_learners_train_on_cpu():
    """APPO, IMPALA and DQN through ``train()``: finite stats, the DQN
    target synced on schedule; multi-agent PPO, one learner a policy."""
    small = dict(num_workers=0, num_envs_per_worker=2, seed=0,
                 fcnet_hiddens=(8,), device="cpu")
    for cls in (IMPALAConfig, APPOConfig):
        algo = cls().environment("RandomEnv").update(dict(
            small, rollout_fragment_length=8,
            num_batches_per_iteration=2)).build()
        info = algo.train()["info"]
        assert info["num_env_steps_trained"] == 32
        assert all(np.isfinite(info[k]) for k in
                   ("policy_loss", "vf_loss", "entropy"))
    algo = DQNConfig().environment("RandomEnv").update(dict(
        small, learning_starts=16, target_network_update_freq=3)).build()
    updates = 0
    for _ in range(12):
        info = algo.train()["info"]
        updates += "mean_td_error" in info
    # 8 frames a step (4 × 2 envs): learning from the 2nd step on; the
    # target copied at the 3rd, 6th and 9th update
    assert updates == 11 and algo.target_syncs == 3
    algo = PPOConfig().environment(make_multi_agent("RandomEnv")).update(
        dict(small, rollout_fragment_length=16, train_batch_size=16,
             sgd_minibatch_size=8, num_sgd_iter=1)).multi_agent(
        policies={"p0", "p1"},
        policy_mapping_fn=lambda aid, *a, **k: "p0" if aid == "agent_0"
        else "p1").build()
    info = algo.train()["info"]
    assert set(info) >= {"p0", "p1"} and np.isfinite(info["p0"]["kl"])


def test_ppo_cartpole_learns():
    """As tests/test_rllib.py's CartPole run: local sampling on the CPU."""
    algo = PPOConfig().environment("CartPole-v1").rollouts(
        num_workers=0, num_envs_per_worker=4,
        rollout_fragment_length=256).training(
        train_batch_size=1024, sgd_minibatch_size=128, num_sgd_iter=6,
        lr=3e-4, entropy_coeff=0.01, fcnet_hiddens=(64, 64)).resources(
        device="cpu").debugging(seed=0).build()
    first, last = None, None
    for _ in range(12):
        result = algo.train()
        if not np.isnan(result["episode_reward_mean"]):
            if first is None:
                first = result["episode_reward_mean"]
            last = result["episode_reward_mean"]
    assert last is not None and first is not None
    assert last > max(60.0, first), (first, last)
    algo.stop()
