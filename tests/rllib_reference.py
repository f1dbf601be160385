"""The JAX package's RLlib learner outputs, for holding the port to the
reference on the card.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/rllib_reference.py

(from the repo root) rewrites the file.

Runs one update of each learner of ``ray_tpu.rllib`` — PPO (two epochs of
one minibatch holding the whole batch), IMPALA, APPO, DQN with
``double_q`` on and off — at the catalog's MLP and a small conv size,
and ``vtrace`` alone, on the CPU in float32, and writes what they compute
to ``tests/data/rllib_reference.json`` (outputs only, never weights).
Then the runs of ``chip_smoke.RL_MORE_RUNS``: SAC, DDPG and TD3 (two
updates) on ``PendulumLite``'s spaces (registered in the JAX package's
env registry here), MARWIL (two updates) and BC, A3C (one
``compute_gradients`` on a fixed fragment, then one apply) and Ape-X
(one update with drawn importance weights).  SAC's and TD3's records
also hold the Gaussian draws the JAX learner makes from its learn key
(``draw/...``), which the port is fed.

Each run builds the algorithm from ``chip_smoke.rl_config`` (local
sampling, no runtime) and draws from ``numpy.random.default_rng((SEED,
i))``, i the run's place in ``RUNS``: the params in the reference's leaf
order (``chip_smoke.rl_draw_tree``), DQN's target params the same way,
then the batch (``chip_smoke.rl_inputs``).  ``chip_smoke.py`` draws the
same numbers and holds the port's outputs to this file, on the card and
(``tests/test_torch_rllib_reference.py``) on the CPU.

Recorded per run: the update's statistics, the global L2 norm of the
loss's gradient at the drawn params (the learner's own loss function),
the global L2 norm of the update (after − before, float64), and a few
leaves after the update (``chip_smoke.RL_LEAVES``).
"""

from __future__ import annotations

import inspect
import json
import pathlib
import sys
import tempfile
from typing import Any, Dict

import numpy as np

from chip_smoke import (RL_CONTINUOUS_ROWS, RL_LEAVES, RL_MORE_LEAVES,
                        RL_MORE_RUNS, RL_REFERENCE, RL_RUNS as RUNS,
                        RL_SEED as SEED, RL_UPDATES, RL_VTRACE_CLIPS,
                        register_pendulum_lite, rl_config, rl_draw_tree,
                        rl_inputs, rl_minibatches, rl_more_record,
                        rl_offline_stub, rl_offpolicy_pairs,
                        rl_offpolicy_state, rl_tree_norm, rl_tree_paths,
                        rl_update_norm)

PATH = pathlib.Path(RL_REFERENCE)


def _entry(x) -> Dict[str, Any]:
    """An array as its shape and float32 values, each written as the
    shortest decimal that reads back to the same float32."""
    a = np.asarray(x, np.float32)
    return {"shape": list(a.shape),
            "values": [float(str(v)) for v in a.reshape(-1)]}


def _grad_of(jitted):
    """The gradient of the learner's own loss function (found in its
    update's closure), jitted."""
    import jax
    loss_fn = inspect.getclosurevars(jitted.__wrapped__).nonlocals["loss_fn"]
    return jax.jit(jax.grad(loss_fn, has_aux=True))


def more_outputs(run: str) -> tuple:
    """A run of RL_MORE_RUNS from the JAX package on the CPU: (its record,
    every tree before the update, every tree after it; numpy in the
    reference's layout)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.rllib import SampleBatch, algorithms, register_env

    register_pendulum_lite(register_env)
    rng = np.random.default_rng((SEED, RUNS.index(run)))
    algo_name, size = run.rsplit("_", 1)
    cls = {"sac": algorithms.SACConfig, "ddpg": algorithms.DDPGConfig,
           "td3": algorithms.TD3Config, "marwil": algorithms.MARWILConfig,
           "bc": algorithms.BCConfig, "a3c": algorithms.A3CConfig,
           "apex": algorithms.APEXConfig}[algo_name]
    with tempfile.TemporaryDirectory() as d:
        algo = cls().update(rl_config(run, rl_offline_stub(run, d))).build()
    policy = algo.workers.local_worker.policy
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    dev = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    extra: Dict[str, Any] = {}
    if algo_name in ("sac", "ddpg", "td3"):
        state = rl_offpolicy_state(
            run, rng,
            [(p, v.shape) for p, v in rl_tree_paths(
                policy.get_weights()["params"])],
            [(p, v.shape) for p, v in rl_tree_paths(host(algo.q1))])
        keys, k = [], algo._learn_key
        for _ in range(RL_UPDATES.get(algo_name, 1)):
            k, sub = jax.random.split(k)          # as training_step splits
            keys.append(sub)
        shape = (RL_CONTINUOUS_ROWS, 1)
        if algo_name == "sac":                    # sac.py:148, :243
            k1, k2 = jax.random.split(keys[0])
            draws = {"next": np.asarray(jax.random.normal(k1, shape)),
                     "actor": np.asarray(jax.random.normal(k2, shape))}
        elif algo_name == "td3":                  # ddpg.py:160
            draws = {"noise": np.stack([np.asarray(
                jax.random.normal(sub, shape)) for sub in keys])}
        else:
            draws = {}
        mbs = rl_minibatches(run, rng, draws, state["actor"])
        mbs = [{k: jnp.asarray(v) for k, v in mb.items()} for mb in mbs]
        names = ("actor", "q1", "q2", "q1_t", "q2_t")
        if algo_name == "sac":
            out = algo._update(
                *(dev(state[n]) for n in names),
                jnp.asarray(state["log_alpha"]), algo._actor_state,
                algo._critic_state, algo._alpha_state, mbs[0], keys[0])
            after = dict(zip(names, map(host, out[:5])))
            after["log_alpha"] = np.float32(out[5])
            extra["log_alpha"] = after["log_alpha"]
            stats = {n: [out[-1][n]] for n in ("alpha", "entropy")}
        else:
            names = ("actor", "actor_t", "q1", "q2", "q1_t", "q2_t")
            trees = tuple(dev(state[n]) for n in names)
            a_s, c_s = algo._actor_state, algo._critic_state
            rows = []
            for u, mb in enumerate(mbs):
                *trees, a_s, c_s, m = algo._update(
                    *trees, a_s, c_s, jnp.asarray(u), mb, keys[u])
                rows.append((m["critic_loss"], m["q_mean"]))
            after = dict(zip(names, map(host, trees)))
            stats = dict(zip(("critic_loss", "q_mean"), zip(*rows)))
        rec = rl_more_record(run, rl_offpolicy_pairs(state, after), after,
                             stats, extra)
        rec.update({f"draw/{k}": v for k, v in draws.items()})
        return rec, state, after
    q_net = algo_name == "apex"
    tree = policy.get_weights()
    shapes = [(p, v.shape) for p, v in rl_tree_paths(
        tree["params"] if q_net else tree)]
    before = rl_draw_tree(rng, shapes)
    target = rl_draw_tree(rng, shapes) if q_net else None
    mbs = rl_minibatches(run, rng)
    params = dev(before)
    if algo_name in ("marwil", "bc"):
        cols = [[jnp.asarray(mb[k]) for k in ("obs", "actions", "returns")]
                for mb in mbs]
        sq_norm, opt_state = algo._sq_norm, algo._opt_state
        grads, _ = _grad_of(algo._update)(params, sq_norm, *cols[0])
        rows = []
        for c in cols:
            params, opt_state, sq_norm, pi_l, vf_l = algo._update(
                params, opt_state, sq_norm, *c)
            rows.append((pi_l, vf_l))
        stats = dict(zip(("policy_loss", "vf_loss"), zip(*rows)))
        extra["grad_norm"] = _global_norm(grads)
        if algo_name == "marwil":
            extra["sq_norm"] = sq_norm
    elif algo_name == "a3c":
        worker = algo.workers.local_worker
        worker.sample = lambda: SampleBatch(dict(mbs[0]))  # the fragment
        policy.params = params
        grads, _, info = worker.compute_gradients(None, **algo._grad_kw)
        params, _ = algo._apply_grads(params, algo._opt_state, grads)
        stats = {k: [info[k]] for k in ("policy_loss", "vf_loss",
                                         "entropy")}
        extra["grad_norm"] = rl_tree_norm(grads)
        for _, path in RL_MORE_LEAVES[("ac", size)][:2]:
            extra[f"grad/{path}"] = dict(rl_tree_paths(grads))[path]
    else:
        mb = {k: jnp.asarray(v) for k, v in mbs[0].items()}
        grads, _ = _grad_of(algo._update)(params, dev(target), mb)
        params, _, td = algo._update(params, dev(target), algo._opt_state,
                                     mb)
        extra["grad_norm"] = _global_norm(grads)
        extra["td_abs"] = td
        stats = {}
    after = host(params)
    return (rl_more_record(run, {"params": (before, after)},
                           {"params": after}, stats, extra),
            {"params": before}, {"params": after})


def _global_norm(tree):
    import jax
    import jax.numpy as jnp
    return jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(
        tree)))


def run_outputs(run: str) -> Dict[str, np.ndarray]:
    """One run's outputs from the JAX package on the CPU."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.rllib import algorithms, vtrace

    if run in RL_MORE_RUNS:
        return more_outputs(run)[0]
    rng = np.random.default_rng((SEED, RUNS.index(run)))
    if run == "vtrace":
        args = {k: jnp.asarray(v) for k, v in rl_inputs(run, rng).items()}
        vs, pg_adv = vtrace(**args, **RL_VTRACE_CLIPS)
        return {"vs": np.asarray(vs), "pg_adv": np.asarray(pg_adv)}
    algo_name, size = run.rsplit("_", 1)
    cls = {"ppo": algorithms.PPOConfig, "impala": algorithms.IMPALAConfig,
           "appo": algorithms.APPOConfig, "dqn": algorithms.DQNConfig}[
        algo_name.split("_")[0]]
    algo = cls().update(rl_config(run)).build()
    policy = algo.workers.local_worker.policy
    q_net = algo_name.startswith("dqn")
    shapes = [(p, v.shape) for p, v in rl_tree_paths(
        policy.get_weights()["params"] if q_net else policy.get_weights())]
    before = rl_draw_tree(rng, shapes)
    target = rl_draw_tree(rng, shapes) if q_net else None
    batch = {k: jnp.asarray(v) for k, v in rl_inputs(run, rng).items()}
    params = jax.tree_util.tree_map(jnp.asarray, before)
    if algo_name == "ppo":
        learner = algo._learners["default_policy"]
        grads, _ = _grad_of(learner["update"])(
            params, batch, learner["kl_coeff"])
        params, _, info = learner["update"](
            params, learner["opt_state"], batch, learner["kl_coeff"],
            jax.random.key(0))
        names = ("kl", "entropy", "vf_loss", "policy_loss")
        stats = [info[n] for n in names]
    elif q_net:
        target = jax.tree_util.tree_map(jnp.asarray, target)
        grads, _ = _grad_of(algo._update)(
            params, target, batch)
        params, _, td = algo._update(params, target, algo._opt_state, batch)
        names, stats = ("mean_td_error",), [td]
    else:
        grads, _ = _grad_of(algo._update)(
            params, batch)
        params, _, info = algo._update(params, algo._opt_state, batch)
        names = ("policy_loss", "vf_loss", "entropy")
        stats = [info[n] for n in names]
    after = jax.tree_util.tree_map(np.asarray, params)
    res = {f"stat/{n}": v for n, v in zip(names, stats)}
    res["grad_norm"] = jnp.sqrt(sum(jnp.sum(g * g) for g in
                                    jax.tree_util.tree_leaves(grads)))
    res["update_norm"] = rl_update_norm(before, after)
    by_path = dict(rl_tree_paths(after))
    for p in RL_LEAVES[("q" if q_net else "ac", size)]:
        res[f"param/{p}"] = by_path[p]
    return {k: np.asarray(v, np.float32) for k, v in res.items()}


def outputs() -> Dict[str, Any]:
    """Every run's outputs, from the JAX package on the CPU."""
    return {"seed": SEED, "runs": {
        run: {k: _entry(v) for k, v in run_outputs(run).items()}
        for run in RUNS}}


def main() -> int:
    PATH.parent.mkdir(exist_ok=True)
    PATH.write_text(json.dumps(outputs(), indent=1) + "\n")
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
