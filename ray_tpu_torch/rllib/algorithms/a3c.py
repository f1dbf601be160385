"""A3C: asynchronous advantage actor-critic, gradient-push workers (port
of ``ray_tpu/rllib/algorithms/a3c.py``).

Reference: ``rllib/algorithms/a3c/`` (Mnih et al. 2016) — the execution
pattern where workers push GRADIENTS, not samples: each rollout worker
computes ∇L on its own fragment and the learner applies the arriving
gradients Hogwild-style, then re-issues the worker with fresh weights.
Versus IMPALA, the learner never touches observations: for fat
observations the gradient (∝ parameter count) is the cheaper thing to
ship.

With remote workers (the default ``num_workers=2``; CPU actors, see
``evaluation.WorkerSet``), one ``compute_gradients(weights_ref)`` stays
in flight per worker; each numpy gradient tree that arrives is applied
on the learner's device at once (optax's global-norm clip and RMSProp,
eps 0.1 inside the root), and that worker is re-issued with a fresh
``put`` of the weights.  With no remote workers (the reference's sync
mode) the local worker computes ``grads_per_iteration`` gradients in
turn, through the same numpy contract.
"""

from __future__ import annotations

from typing import Any, Dict

import ray_tpu_torch as rt
from ray_tpu_torch.parallel import transforms as tx
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.algorithms.algorithm import (
    Algorithm, AlgorithmConfig, apply_updates)


class A3CConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or A3C)
        self._cfg.update({
            "lr": 1e-4, "num_workers": 2, "rollout_fragment_length": 50,
            "vf_loss_coeff": 0.5, "entropy_coeff": 0.01, "grad_clip": 40.0,
            "grads_per_iteration": 10,
        })


class A3C(Algorithm):
    _default_config_cls = A3CConfig

    def setup(self, config: Dict[str, Any]) -> None:
        policy = self.workers.local_worker.policy
        self._optimizer = tx.chain(
            tx.clip_by_global_norm(float(config["grad_clip"])),
            tx.rmsprop(float(config["lr"]), decay=0.99, eps=0.1))
        self._opt_state = self._optimizer.init(policy.params)
        self._grad_kw = {
            "vf_loss_coeff": float(config["vf_loss_coeff"]),
            "entropy_coeff": float(config["entropy_coeff"]),
        }
        self._in_flight: Dict[Any, Any] = {}
        self._trained_steps = 0

    def apply_gradients(self, grads) -> None:
        """One optimizer step on a numpy gradient tree in the reference's
        layout (what ``compute_gradients`` returns), params in place."""
        policy = self.workers.local_worker.policy
        g = models.params_from_numpy(grads, policy.model_config,
                                     policy.device)
        updates, _ = self._optimizer.update(g, self._opt_state,
                                            policy.params)
        apply_updates(policy.params, updates)

    def training_step(self) -> Dict[str, Any]:
        remotes = self.workers.remote_workers
        n = int(self.config["grads_per_iteration"])
        policy = self.workers.local_worker.policy
        info: Dict[str, Any] = {}
        if not remotes:  # sync mode on the local worker
            for _ in range(n):
                grads, count, info = \
                    self.workers.local_worker.compute_gradients(
                        None, **self._grad_kw)
                self.apply_gradients(grads)
                self._trained_steps += count
            info = dict(info)
            info["num_env_steps_trained"] = self._trained_steps
            return info
        # Hogwild: keep one gradient computation in flight per worker;
        # each completion is applied immediately and the worker re-issued
        # with the freshest weights.
        weights_ref = rt.put(policy.get_weights())
        busy = set(self._in_flight.values())
        for w in remotes:
            if w not in busy:
                self._in_flight[w.compute_gradients.remote(
                    weights_ref, **self._grad_kw)] = w
        applied = 0
        while applied < n:
            ready, _ = rt.wait(list(self._in_flight), num_returns=1)
            fut = ready[0]
            worker = self._in_flight.pop(fut)
            grads, count, info = rt.get(fut)
            self.apply_gradients(grads)
            self._trained_steps += count
            applied += 1
            weights_ref = rt.put(policy.get_weights())
            self._in_flight[worker.compute_gradients.remote(
                weights_ref, **self._grad_kw)] = worker
        info = dict(info)
        info["num_env_steps_trained"] = self._trained_steps
        return info
