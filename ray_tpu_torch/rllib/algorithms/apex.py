"""Ape-X: prioritized experience replay DQN (APEX-DQN), its
single-process path (port of ``ray_tpu/rllib/algorithms/apex.py``).

Reference: ``rllib/algorithms/apex_dqn/`` (+ the Ape-X paper's
architecture): rollout workers, each with its own epsilon from the Ape-X
ladder, stream fragments into replay shards; the learner pulls
prioritized minibatches, applies importance-weighted TD updates and
pushes the new TD errors back as priorities.

The port runs the reference's single-process mode: the local worker
samples (epsilon annealed as DQN's), one local ``PrioritizedReplay``
holds the whole configured capacity, and each update is the reference's
importance-weighted SQUARED double-Q TD on the policy's device, with the
per-sample ``|td|`` read back once an update for the priorities
(``+1e-6`` in ``update_priorities``).  The target is a copy of the
params taken every ``target_network_update_freq`` updates.  The replay
shard actors and the remote workers need the runtime: ``num_workers >
0`` raises at build time (``WorkerSet``), and the fleet's keys
(``num_replay_shards``, ``apex_epsilon_base``, ``apex_epsilon_ladder``,
``broadcast_interval``) return with it in the runtime slice.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.parallel import transforms as tx
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.algorithms.algorithm import (
    Algorithm, apply_updates, grads_with_aux)
from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig, DQNPolicy
from ray_tpu_torch.rllib.algorithms.sac import device_minibatch
from ray_tpu_torch.rllib.policy import to_device
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, NEXT_OBS, OBS, REWARDS, TERMINATEDS)

_REPLAY_KEYS = (OBS, ACTIONS, REWARDS, NEXT_OBS, TERMINATEDS)


class PrioritizedReplay:
    """Proportional prioritized replay over column arrays (one shard; a
    copy of the reference's, numpy there too).

    Reference: ``rllib/utils/replay_buffers/prioritized_episode_buffer``.
    New entries get the running max priority (optimistic: every sample is
    seen at least once); ``sample`` draws ∝ p^alpha and returns the
    importance weights for beta-annealed bias correction.
    """

    def __init__(self, capacity: int, alpha: float = 0.6, seed: int = 0):
        self.capacity = int(capacity)
        self.alpha = float(alpha)
        self._cols: Dict[str, np.ndarray] = {}
        self._prio = np.zeros(self.capacity, np.float64)
        self._idx = 0
        self._size = 0
        self._max_prio = 1.0
        self._rng = np.random.default_rng(seed)

    def add_batch(self, batch) -> int:
        n = int(batch.count if hasattr(batch, "count")
                else len(batch[REWARDS]))
        idx = (self._idx + np.arange(n)) % self.capacity
        for k in _REPLAY_KEYS:
            v = np.asarray(batch[k])
            if k not in self._cols:
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                         v.dtype)
            self._cols[k][idx] = v[:n]
        self._prio[idx] = self._max_prio
        self._idx = (self._idx + n) % self.capacity
        self._size = min(self._size + n, self.capacity)
        return self._size

    def sample(self, n: int, beta: float = 0.4):
        """→ (columns dict, indices, importance weights) or None if empty."""
        if self._size == 0:
            return None
        p = self._prio[:self._size] ** self.alpha
        tot = p.sum()
        if tot <= 0:
            probs = np.full(self._size, 1.0 / self._size)
        else:
            probs = p / tot
        idx = self._rng.choice(self._size, size=n, p=probs)
        w = (self._size * probs[idx]) ** (-float(beta))
        w = (w / w.max()).astype(np.float32)
        cols = {k: v[idx] for k, v in self._cols.items()}
        return cols, idx.astype(np.int64), w

    def update_priorities(self, idx, prios) -> None:
        pr = np.abs(np.asarray(prios, np.float64)) + 1e-6
        self._prio[np.asarray(idx)] = pr
        self._max_prio = max(self._max_prio, float(pr.max()))

    def size(self) -> int:
        return self._size


def apex_epsilons(n: int, base: float = 0.4, ladder: float = 7.0
                  ) -> List[float]:
    """The Ape-X exploration ladder: eps_i = base^(1 + i/(N-1)*ladder)."""
    if n <= 1:
        return [base]
    return [float(base ** (1.0 + ladder * i / (n - 1))) for i in range(n)]


def weighted_td_loss(td: torch.Tensor, is_weights: torch.Tensor
                     ) -> torch.Tensor:
    """The importance-weighted squared TD error (no Huber)."""
    return (is_weights * torch.square(td)).mean()


class APEXConfig(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or APEX)
        self._cfg.update({
            "prioritized_replay_alpha": 0.6,
            "prioritized_replay_beta": 0.4,
            "num_updates_per_iteration": 16,
            "learning_starts": 256,
        })


class APEX(Algorithm):
    _default_config_cls = APEXConfig

    def setup(self, config: Dict[str, Any]) -> None:
        policy: DQNPolicy = self.workers.local_worker.policy
        self._optimizer = tx.adam(config["lr"])
        self._opt_state = self._optimizer.init(policy.params)
        self.target_params = models.clone_params(policy.params)
        self.target_syncs = 0
        self._since_target = 0
        self._added = 0
        self._updates = 0
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
            # per-sample |td| out for the priority push-back
            return weighted_td_loss(td, mb["is_weights"]), torch.abs(td)

        def update(params, target_params, opt_state, mb):
            """One Adam step, params and opt_state in place; returns the
            per-sample |TD error| on the device."""
            grads, td = grads_with_aux(loss_fn, params, target_params, mb)
            updates, _ = optimizer.update(grads, opt_state, params)
            apply_updates(params, updates)
            return td

        self._loss_fn = loss_fn
        self._update = update
        # the single-process mode: one local buffer with the user's FULL
        # configured size (the shards split it only for the fleet)
        self._local_replay = PrioritizedReplay(
            int(config["buffer_size"]),
            float(config["prioritized_replay_alpha"]))

    def device_minibatch(self, cols: Dict[str, np.ndarray], w: np.ndarray
                         ) -> Dict[str, torch.Tensor]:
        dev = self.workers.local_worker.policy.device
        out = device_minibatch(cols, dev, ACTIONS)
        out["is_weights"] = to_device(w, dev)
        return out

    def _learn(self, cols, idx, w) -> Dict[str, Any]:
        policy = self.workers.local_worker.policy
        td = self._update(policy.params, self.target_params,
                          self._opt_state, self.device_minibatch(cols, w))
        self._updates += 1
        self._since_target += 1
        td_host = td.cpu().numpy()                   # the one host read
        self._local_replay.update_priorities(idx, td_host)
        if self._since_target >= int(
                self.config["target_network_update_freq"]):
            self.target_params = models.clone_params(policy.params)
            self.target_syncs += 1
            self._since_target = 0
        return {"mean_td_error": float(td_host.mean())}

    def set_learner_state(self, state: Dict[str, Any]) -> None:
        """The target params from numpy in the reference's layout
        (``target``)."""
        policy = self.workers.local_worker.policy
        self.target_params = models.params_from_numpy(
            state["target"], policy.model_config, policy.device)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        policy = self.workers.local_worker.policy
        # single-process mode has no exploration ladder: anneal epsilon
        # like DQN does
        frac = min(1.0, self._added / float(cfg["epsilon_timesteps"]))
        policy.epsilon = float(
            cfg["initial_epsilon"] + frac *
            (cfg["final_epsilon"] - cfg["initial_epsilon"]))
        batch = self.workers.local_worker.sample()
        self._added += batch.count
        self._local_replay.add_batch(batch)
        info: Dict[str, Any] = {"num_env_steps_sampled": self._added,
                                "buffer_size": self._local_replay.size()}
        if self._added < int(cfg["learning_starts"]):
            return info
        for _ in range(int(cfg["num_updates_per_iteration"])):
            out = self._local_replay.sample(
                int(cfg["train_batch_size"]),
                float(cfg["prioritized_replay_beta"]))
            if out is None:
                break
            cols, idx, w = out
            info.update(self._learn(cols, idx, w))
        info["learner_updates"] = self._updates
        return info
