"""The JAX package's RLlib learner outputs, for holding the port to the
reference on the card.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/rllib_reference.py

(from the repo root) rewrites the file.

Runs one update of each learner of ``ray_tpu.rllib`` — PPO (two epochs of
one minibatch holding the whole batch), IMPALA, APPO, DQN with
``double_q`` on and off — at the catalog's MLP and a small conv size,
and ``vtrace`` alone, on the CPU in float32, and writes what they compute
to ``tests/data/rllib_reference.json`` (outputs only, never weights).

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
from typing import Any, Dict

import numpy as np

from chip_smoke import (RL_LEAVES, RL_REFERENCE, RL_RUNS as RUNS,
                        RL_SEED as SEED, RL_VTRACE_CLIPS, rl_config,
                        rl_draw_tree, rl_inputs, rl_tree_paths,
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


def run_outputs(run: str) -> Dict[str, np.ndarray]:
    """One run's outputs from the JAX package on the CPU."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.rllib import algorithms, vtrace

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
