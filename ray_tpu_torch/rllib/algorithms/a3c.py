"""A3C: asynchronous advantage actor-critic, gradient-push workers (port
of ``ray_tpu/rllib/algorithms/a3c.py``).

Reference: ``rllib/algorithms/a3c/`` (Mnih et al. 2016) — the execution
pattern where workers push GRADIENTS, not samples: each rollout worker
computes ∇L on its own fragment and the learner applies the arriving
gradients, then re-issues the worker with fresh weights.

The port runs the reference's local mode (no remote workers, its
"degenerate sync mode"): ``grads_per_iteration`` times, the local
worker's ``compute_gradients`` returns a numpy gradient tree in the
reference's layout, which goes back to the device and through optax's
global-norm clip and RMSProp (eps 0.1 inside the root).  The round trip
through numpy is the reference's contract, kept for the remote workers
to come.  The Hogwild path needs the runtime's actors: the reference's
default ``num_workers=2`` raises at build time (``WorkerSet``), so set
``num_workers=0``.
"""

from __future__ import annotations

from typing import Any, Dict

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
        worker = self.workers.local_worker
        info: Dict[str, Any] = {}
        for _ in range(int(self.config["grads_per_iteration"])):
            grads, count, info = worker.compute_gradients(None,
                                                          **self._grad_kw)
            self.apply_gradients(grads)
            self._trained_steps += count
        info = dict(info)
        info["num_env_steps_trained"] = self._trained_steps
        return info
