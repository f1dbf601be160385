"""DQN: off-policy Q-learning with replay + target network (double-DQN)
(port of ``ray_tpu/rllib/algorithms/dqn.py``).

Reference: ``rllib/algorithms/dqn/`` — epsilon-greedy rollouts feed a
replay buffer; the learner samples uniform minibatches and minimizes the
double-DQN TD error against a periodically-synced target net.  The
buffer and epsilon-greedy keep the reference's numpy generators; the
Q-net and its Adam step run on the policy's device.  The target net is a
copy of the params (the learner updates the params in place), taken
every ``target_network_update_freq`` updates.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.parallel import transforms as tx
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.algorithms.algorithm import (
    Algorithm, AlgorithmConfig, apply_updates, grads_with_aux)
from ray_tpu_torch.rllib.evaluation import synchronous_parallel_sample
from ray_tpu_torch.rllib.policy import to_device
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, NEXT_OBS, OBS, REWARDS, SampleBatch, TERMINATEDS, VF_PREDS,
    ACTION_LOGP, ACTION_DIST_INPUTS)


class DQNPolicy:
    """Epsilon-greedy policy over a Q-network (replaces the actor-critic
    Policy inside RolloutWorker via ``config['policy_class']``)."""

    def __init__(self, observation_space, action_space,
                 config: Optional[dict] = None):
        config = config or {}
        self.observation_space = observation_space
        self.action_space = action_space
        self.config = config
        self.device = resolve_device(config.get("device"))
        self.model_config = models.make_model_config(
            observation_space, action_space,
            {"fcnet_hiddens": (64, 64), **config})
        seed = config.get("seed", 0)
        # catalog: MLP Q-net for flat obs, Nature-CNN torso + linear Q
        # head for rank-3 (pixel) obs
        self.params, self.q_apply = models.make_q_net(
            torch.Generator(device=self.device).manual_seed(seed),
            self.model_config)
        self.epsilon = float(config.get("initial_epsilon", 1.0))
        self._rng = np.random.default_rng(seed)

    @torch.no_grad()
    def _q(self, obs: np.ndarray) -> np.ndarray:
        """Q-values on the host: one upload, one device call, one copy
        back."""
        return self.q_apply(self.params, to_device(obs, self.device)) \
            .cpu().numpy()

    def compute_actions(self, obs: np.ndarray, explore: bool = True):
        q = self._q(obs)
        actions = q.argmax(axis=-1)
        if explore:
            mask = self._rng.uniform(size=len(actions)) < self.epsilon
            rand = self._rng.integers(0, q.shape[-1], size=len(actions))
            actions = np.where(mask, rand, actions)
        # VF_PREDS/logp filled so GAE postprocessing stays well-defined
        # (unused by the DQN learner).
        extras = {VF_PREDS: q.max(axis=-1).astype(np.float32),
                  ACTION_LOGP: np.zeros(len(actions), np.float32),
                  ACTION_DIST_INPUTS: q.astype(np.float32)}
        return actions.astype(np.int64), extras

    def compute_single_action(self, obs, explore: bool = True):
        a, extras = self.compute_actions(obs[None], explore)
        return a[0], {k: v[0] for k, v in extras.items()}

    def value(self, obs: np.ndarray) -> np.ndarray:
        return self._q(obs).max(axis=-1)

    def get_weights(self):
        return {"params": models.params_to_numpy(self.params),
                "epsilon": self.epsilon}

    def set_weights(self, weights):
        self.params = models.params_from_numpy(
            weights["params"], self.model_config, self.device)
        # absent => keep: Ape-X broadcasts params-only dicts so each
        # worker keeps its own exploration-ladder epsilon
        self.epsilon = weights.get("epsilon", self.epsilon)


class ReplayBuffer:
    """Uniform ring buffer over column arrays (reference:
    ``rllib/utils/replay_buffers``)."""

    DEFAULT_KEYS = (OBS, ACTIONS, REWARDS, NEXT_OBS, TERMINATEDS)

    def __init__(self, capacity: int, keys: Optional[tuple] = None):
        self.capacity = capacity
        self.keys = tuple(keys) if keys else self.DEFAULT_KEYS
        self._cols: Dict[str, np.ndarray] = {}
        self._idx = 0
        self._size = 0

    def add_batch(self, batch: SampleBatch) -> None:
        n = batch.count
        for k in self.keys:
            v = batch[k]
            if k not in self._cols:
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                         v.dtype)
            idx = (self._idx + np.arange(n)) % self.capacity
            self._cols[k][idx] = v
        self._idx = (self._idx + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, n: int, rng: np.random.Generator) -> SampleBatch:
        idx = rng.integers(0, self._size, size=n)
        return SampleBatch({k: v[idx] for k, v in self._cols.items()})

    def __len__(self) -> int:
        return self._size


class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DQN)
        self._cfg.update({
            "policy_class": DQNPolicy,
            "lr": 5e-4, "buffer_size": 50_000, "learning_starts": 1000,
            "train_batch_size": 32, "target_network_update_freq": 500,
            "initial_epsilon": 1.0, "final_epsilon": 0.02,
            "epsilon_timesteps": 10_000, "gamma": 0.99,
            "rollout_fragment_length": 4, "double_q": True,
            "num_sgd_per_step": 1,
        })


class DQN(Algorithm):
    _default_config_cls = DQNConfig

    def setup(self, config: Dict[str, Any]) -> None:
        policy = self.workers.local_worker.policy
        self.buffer = ReplayBuffer(int(config["buffer_size"]))
        self._optimizer = tx.adam(config["lr"])
        self._opt_state = self._optimizer.init(policy.params)
        self.target_params = models.clone_params(policy.params)
        self.target_syncs = 0
        self._steps_since_target_sync = 0
        self._sampled = 0
        self._rng = np.random.default_rng(config.get("seed") or 0)
        gamma = float(config["gamma"])
        double_q = bool(config["double_q"])
        q_apply = policy.q_apply
        optimizer = self._optimizer

        def loss_fn(params, target_params, mb):
            q = q_apply(params, mb[OBS])
            q_taken = torch.gather(
                q, 1, mb[ACTIONS].reshape(-1, 1).to(torch.int64))[:, 0]
            with torch.no_grad():         # the target carries no gradient
                q_next_target = q_apply(target_params, mb[NEXT_OBS])
                if double_q:
                    best = torch.argmax(q_apply(params, mb[NEXT_OBS]),
                                        dim=-1)
                    q_next = torch.gather(q_next_target, 1,
                                          best[:, None])[:, 0]
                else:
                    q_next = q_next_target.max(dim=-1).values
                target = mb[REWARDS] + gamma * (1.0 - mb["dones"]) * q_next
            td = q_taken - target
            return torch.square(td).mean(), torch.abs(td).mean()

        def update(params, target_params, opt_state, mb):
            """One Adam step, params and opt_state in place; returns the
            mean |TD error| as a device scalar."""
            grads, td = grads_with_aux(loss_fn, params, target_params, mb)
            updates, _ = optimizer.update(grads, opt_state, params)
            apply_updates(params, updates)
            return td

        self._loss_fn = loss_fn
        self._update = update

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._sampled / float(cfg["epsilon_timesteps"]))
        return float(cfg["initial_epsilon"] + frac *
                     (cfg["final_epsilon"] - cfg["initial_epsilon"]))

    def training_step(self) -> Dict[str, Any]:
        policy = self.workers.local_worker.policy
        policy.epsilon = self._epsilon()
        batch = synchronous_parallel_sample(self.workers)
        self._sampled += batch.count
        self.buffer.add_batch(batch)
        info: Dict[str, Any] = {"epsilon": policy.epsilon,
                                "buffer_size": len(self.buffer)}
        if len(self.buffer) < int(self.config["learning_starts"]):
            return info
        td = None
        for _ in range(int(self.config["num_sgd_per_step"])):
            mb = self.buffer.sample(int(self.config["train_batch_size"]),
                                    self._rng)
            mb["dones"] = mb[TERMINATEDS].astype(np.float32)
            device_mb = {k: to_device(mb[k], policy.device) for k in
                         (OBS, ACTIONS, REWARDS, NEXT_OBS, "dones")}
            td = self._update(policy.params, self.target_params,
                              self._opt_state, device_mb)
            self._steps_since_target_sync += 1
        info["mean_td_error"] = float(td)             # the one host read
        if self._steps_since_target_sync >= \
                int(self.config["target_network_update_freq"]):
            self.target_params = models.clone_params(policy.params)
            self.target_syncs += 1
            self._steps_since_target_sync = 0
        return info
