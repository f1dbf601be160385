"""MARWIL + BC: offline RL from recorded experiences (port of
``ray_tpu/rllib/algorithms/marwil.py``).

Reference: ``rllib/algorithms/marwil/`` (Wang et al. 2018,
"Exponentially Weighted Imitation Learning") and
``rllib/algorithms/bc/`` — learn a policy from a fixed dataset with no
environment interaction:

- value head regresses monte-carlo returns;
- advantage = return − V(s), normalized by a running mean-square (the
  paper's c² estimate, starting at 100 and updated inside the loss
  before it normalizes);
- policy loss = −E[min(exp(β·Â/√(c² + 1e-8)), 20) · log π(a|s)] — β=0
  is exactly behavior cloning (weight 1), which ``BC`` pins.

The env in the config is used only for spaces and ``evaluate()``; the
training loop touches nothing but the dataset (``config["input"]``, a
JSON-lines episode dir — see ``rllib/offline.py``).  Each minibatch is
one upload and one clipped-Adam step on the policy's device; the
iteration's loss statistics are the mean over its minibatches, read from
the device once.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.parallel import transforms as tx
from ray_tpu_torch.rllib.algorithms.algorithm import (
    Algorithm, AlgorithmConfig, apply_updates, grads_with_aux)
from ray_tpu_torch.rllib.offline import OfflineData
from ray_tpu_torch.rllib.policy import to_device
from ray_tpu_torch.rllib.sample_batch import ACTIONS, OBS


class MARWILConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MARWIL)
        self._cfg.update({
            "input": None,              # path to JSON-lines episode data
            "beta": 1.0,                # 0 = behavior cloning
            "lr": 1e-4, "train_batch_size": 512,
            "vf_loss_coeff": 1.0, "grad_clip": 40.0,
            "updates_per_iteration": 50,
            # running ⟨Â²⟩ update rate (reference: moving_average_sqd_adv_norm)
            "vf_norm_rate": 1e-3,
        })

    def offline_data(self, *, input=None, **kw):  # noqa: A002 - ref name
        if input is not None:
            self._cfg["input"] = input
        self._cfg.update(kw)
        return self


def advantage_weights(adv: torch.Tensor, sq_norm: torch.Tensor,
                      beta: float, rate: float):
    """(the exponentiated weights, the updated running ⟨Â²⟩): ``c²`` moves
    toward this minibatch's mean ``Â²`` first, then normalizes it; the
    weights are clipped at 20 (bounded importance keeps the estimator
    finite).  ``adv`` carries no gradient."""
    sq_norm = sq_norm + rate * (torch.square(adv).mean() - sq_norm)
    w = torch.exp(beta * adv / torch.sqrt(sq_norm + 1e-8))
    return torch.clamp(w, max=20.0), sq_norm


class MARWIL(Algorithm):
    _default_config_cls = MARWILConfig

    def setup(self, config: Dict[str, Any]) -> None:
        if not config.get("input"):
            raise ValueError(
                f"{type(self).__name__} is offline: set config['input'] to "
                "a JSON-lines episode dir (rllib/offline.py)")
        self.data = OfflineData(config["input"],
                                gamma=float(config["gamma"]))
        policy = self.workers.local_worker.policy
        apply_fn = policy.apply_fn
        dist = policy.dist_class
        beta = float(config["beta"])
        vf_coeff = float(config["vf_loss_coeff"])
        rate = float(config["vf_norm_rate"])
        self._optimizer = tx.chain(
            tx.clip_by_global_norm(float(config["grad_clip"])),
            tx.adam(float(config["lr"])))
        self._opt_state = self._optimizer.init(policy.params)
        # running ⟨Â²⟩ for the exponent's normalization (paper's c²)
        self._sq_norm = torch.full((), 100.0, dtype=torch.float32,
                                   device=policy.device)
        optimizer = self._optimizer

        def loss_fn(params, sq_norm, obs, actions, returns):
            inputs, values = apply_fn(params, obs)
            logp = dist.logp(inputs, actions)
            adv = returns - values
            vf_loss = 0.5 * torch.square(adv).mean()
            if beta != 0.0:
                w, sq_norm = advantage_weights(adv.detach(), sq_norm, beta,
                                               rate)
            else:
                w = 1.0                  # BC: plain log-likelihood
            pi_loss = -(w * logp).mean()
            total = pi_loss + vf_coeff * vf_loss
            return total, (sq_norm, pi_loss, vf_loss)

        def update(params, opt_state, sq_norm, obs, actions, returns):
            """One step, params and opt_state in place; returns (the new
            running ⟨Â²⟩, policy_loss, vf_loss) as device scalars."""
            grads, aux = grads_with_aux(loss_fn, params, sq_norm, obs,
                                        actions, returns)
            updates, _ = optimizer.update(grads, opt_state, params)
            apply_updates(params, updates)
            return aux

        self._loss_fn = loss_fn
        self._update = update
        self._rng = np.random.default_rng(config.get("seed") or 0)
        self._trained = 0

    def learn_on(self, mb: Dict[str, np.ndarray]):
        """One update on a host minibatch (``obs``, ``actions``,
        ``returns``); returns (policy_loss, vf_loss) on the device."""
        policy = self.workers.local_worker.policy
        dev = policy.device
        self._sq_norm, pi_l, vf_l = self._update(
            policy.params, self._opt_state, self._sq_norm,
            to_device(mb[OBS], dev), to_device(mb[ACTIONS], dev),
            to_device(mb["returns"], dev))
        self._trained += len(mb[OBS])
        return pi_l, vf_l

    def training_step(self) -> Dict[str, Any]:
        policy = self.workers.local_worker.policy
        if float(self.config["beta"]) != 0.0:
            # refresh truncated episodes' bootstrapped returns against
            # the current value head (one batched forward per iteration)
            self.data.rebuild_returns(policy.value)
        bs = int(self.config["train_batch_size"])
        # the MEAN over the iteration's minibatches (reference behavior),
        # kept on the device and read once
        losses = [torch.stack(self.learn_on(self.data.minibatch(self._rng,
                                                                 bs)))
                  for _ in range(int(self.config["updates_per_iteration"]))]
        pi_l, vf_l = torch.stack(losses).mean(0).tolist() if losses \
            else (0.0, 0.0)
        return {"policy_loss": float(pi_l), "vf_loss": float(vf_l),
                "num_steps_trained": self._trained,
                "dataset_episodes": self.data.episodes,
                "dataset_transitions": self.data.count}


class BCConfig(MARWILConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or BC)
        self._cfg.update({"beta": 0.0, "vf_loss_coeff": 0.0})


class BC(MARWIL):
    """Behavior cloning = MARWIL with β=0 (reference: ``rllib/algorithms/
    bc/`` subclasses MARWIL the same way)."""

    _default_config_cls = BCConfig
