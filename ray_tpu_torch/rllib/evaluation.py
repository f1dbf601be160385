"""RolloutWorker + WorkerSet: the sampling side of every algorithm (port
of ``ray_tpu/rllib/evaluation.py``).

Reference: ``rllib/evaluation/rollout_worker.py`` + ``WorkerSet`` — each
worker holds env(s) + a policy copy, steps the vectorized env in its hot
loop, and emits SampleBatches; the set is 1 local worker + N remote
actors.  The policy inference inside the loop is one device call over
the whole vector of envs (``Policy.compute_actions``).

The local worker's policy lives on ``config["device"]`` (the card
unless the config says ``"cpu"``): it is the learner's.  The remote
workers are actors of the port's runtime with ``num_cpus_per_worker``
CPUs and a copy of the config with ``device="cpu"``: the runtime gives a
plain actor a worker that sees no card, and rollouts run on the CPU, as
upstream RLlib's rollout workers do by default.  Weights travel as the
numpy trees of ``get_weights`` / ``set_weights``, so nothing moves
between devices in the object store.  The A3C worker step
(``compute_gradients``) returns the reference's contract, a numpy
gradient tree in the reference's layout.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.rllib import env as env_lib
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.policy import Policy, compute_gae, to_device
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, ADVANTAGES, EPS_ID, OBS, NEXT_OBS, REWARDS, SampleBatch,
    TERMINATEDS, TRUNCATEDS, VALUE_TARGETS, MultiAgentBatch, concat_samples)


class RolloutWorker:
    """Holds ``num_envs_per_worker`` envs + a policy; ``sample()`` returns a
    postprocessed SampleBatch of ``rollout_fragment_length *
    num_envs_per_worker`` timesteps."""

    def __init__(self, config: Dict[str, Any], worker_index: int = 0):
        self.config = dict(config)
        self.worker_index = worker_index
        num_envs = int(config.get("num_envs_per_worker", 1))
        seed = config.get("seed")
        if seed is not None:
            seed = int(seed) + 1000 * worker_index
            np.random.seed(seed)
        creator = lambda: env_lib.create_env(  # noqa: E731
            config["env"], config.get("env_config"))
        self.vector_env = env_lib.VectorEnv(creator, num_envs, seed=seed)
        pol_config = dict(config)
        pol_config["seed"] = (seed or 0) + 17
        policy_cls = config.get("policy_class") or Policy
        self.policy = policy_cls(self.vector_env.observation_space,
                                 self.vector_env.action_space, pol_config)
        self.fragment_length = int(config.get("rollout_fragment_length", 200))
        self.gamma = float(config.get("gamma", 0.99))
        self.lam = float(config.get("lambda", 0.95))
        self._obs = self.vector_env.reset_all()
        self._eps_ids = np.arange(num_envs, dtype=np.int64) \
            + 1_000_000 * worker_index
        self._next_eps_id = num_envs
        self._ep_rewards = np.zeros(num_envs, np.float64)
        self._ep_lens = np.zeros(num_envs, np.int64)
        self._completed: collections.deque = collections.deque(maxlen=100)
        self._total_steps = 0

    def sample(self) -> SampleBatch:
        num_envs = self.vector_env.num_envs
        T = self.fragment_length
        cols: Dict[str, list] = collections.defaultdict(list)
        for _ in range(T):
            actions, extras = self.policy.compute_actions(self._obs)
            next_obs, final_obs, rewards, terms, truncs = \
                self.vector_env.step(actions)
            cols[OBS].append(self._obs)
            cols[ACTIONS].append(actions)
            cols[REWARDS].append(rewards)
            cols[NEXT_OBS].append(final_obs)
            cols[TERMINATEDS].append(terms)
            cols[TRUNCATEDS].append(truncs)
            cols[EPS_ID].append(self._eps_ids.copy())
            for k, v in extras.items():
                cols[k].append(v)
            self._ep_rewards += rewards
            self._ep_lens += 1
            done = terms | truncs
            for i in np.flatnonzero(done):
                self._completed.append(
                    (float(self._ep_rewards[i]), int(self._ep_lens[i])))
                self._ep_rewards[i] = 0.0
                self._ep_lens[i] = 0
                self._eps_ids[i] = (1_000_000 * self.worker_index
                                    + self._next_eps_id)
                self._next_eps_id += 1
            self._obs = next_obs
            self._total_steps += num_envs

        # [T, num_envs, ...] → per-env rows, then postprocess per episode.
        stacked = {k: np.stack(v) for k, v in cols.items()}
        per_env = []
        for i in range(num_envs):
            env_batch = SampleBatch({k: v[:, i] for k, v in stacked.items()})
            for ep in env_batch.split_by_episode():
                # Terminated → compute_gae bootstraps 0; truncated or
                # fragment-cut → bootstrap with V(true final obs).
                last_value = float(self.policy.value(ep[NEXT_OBS][-1:])[0])
                per_env.append(compute_gae(ep, last_value, self.gamma,
                                           self.lam))
        return concat_samples(per_env)

    def sample_with_weights(self, weights: Optional[dict]) -> SampleBatch:
        """One round trip: set weights then sample (IMPALA-style pipeline)."""
        if weights is not None:
            self.policy.set_weights(weights)
        return self.sample()

    def compute_gradients(self, weights: Optional[dict],
                          vf_loss_coeff: float = 0.5,
                          entropy_coeff: float = 0.01):
        """A3C worker step: sample a fragment, compute a2c gradients ON
        THE WORKER, return (numpy grad tree in the reference's layout,
        steps, metrics) — the gradient-push execution pattern (reference:
        a3c async_optimizer).  Advantages are normalized on the host with
        numpy's population std; the gradient comes back in one
        device-to-host copy."""
        # algorithm.py imports this module
        from ray_tpu_torch.rllib.algorithms.algorithm import grads_with_aux
        if weights is not None:
            self.policy.set_weights(weights)
        batch = self.sample()
        apply_fn = self.policy.apply_fn
        dist = self.policy.dist_class

        def loss(params, obs, actions, adv, targets):
            inputs, values = apply_fn(params, obs)
            logp = dist.logp(inputs, actions)
            entropy = dist.entropy(inputs).mean()
            pi_loss = -(logp * adv).mean()
            vf_loss = 0.5 * torch.square(values - targets).mean()
            total = pi_loss + vf_loss_coeff * vf_loss \
                - entropy_coeff * entropy
            return total, (pi_loss, vf_loss, entropy)

        adv = batch[ADVANTAGES]
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        dev = self.policy.device
        grads, aux = grads_with_aux(
            loss, self.policy.params, *(to_device(x, dev) for x in (
                batch[OBS], batch[ACTIONS], adv, batch[VALUE_TARGETS])))
        pi_l, vf_l, ent = torch.stack(aux).tolist()
        return models.params_to_numpy(grads), batch.count, {
            "policy_loss": pi_l, "vf_loss": vf_l, "entropy": ent}

    def get_weights(self) -> dict:
        return self.policy.get_weights()

    def set_weights(self, weights: dict) -> None:
        self.policy.set_weights(weights)

    def get_metrics(self) -> Dict[str, Any]:
        eps = list(self._completed)
        self._completed.clear()
        return {
            "episode_rewards": [r for r, _ in eps],
            "episode_lens": [l for _, l in eps],
            "num_env_steps": self._total_steps,
        }

    def get_spaces(self):
        return (self.vector_env.observation_space,
                self.vector_env.action_space)


class WorkerSet:
    """1 local worker (learner-side policy + spaces) + N remote actors."""

    def __init__(self, config: Dict[str, Any]):
        self.config = config
        worker_cls = RolloutWorker
        if config.get("multiagent"):
            from ray_tpu_torch.rllib.multi_agent import \
                MultiAgentRolloutWorker
            worker_cls = MultiAgentRolloutWorker
        self.local_worker = worker_cls(config, worker_index=0)
        num_workers = int(config.get("num_workers", 0))
        remote_cls = rt.remote(worker_cls).options(
            num_cpus=config.get("num_cpus_per_worker", 1))
        # rollouts on the CPU: a plain actor's worker sees no card
        remote_config = dict(config, device="cpu")
        self.remote_workers: List = [
            remote_cls.remote(remote_config, worker_index=i + 1)
            for i in range(num_workers)]

    def sync_weights(self) -> None:
        """Broadcast local weights to all remotes via one object-store put."""
        if not self.remote_workers:
            return
        ref = rt.put(self.local_worker.get_weights())
        rt.get([w.set_weights.remote(ref) for w in self.remote_workers])

    def stop(self) -> None:
        for w in self.remote_workers:
            rt.kill(w)
        self.remote_workers = []


def synchronous_parallel_sample(worker_set: WorkerSet) -> SampleBatch:
    """Reference: ``rllib/execution/rollout_ops.py`` — one sample() round
    across the set (remote if any remotes, else local); a
    ``MultiAgentBatch`` for multi-agent workers."""
    if worker_set.remote_workers:
        batches = rt.get(
            [w.sample.remote() for w in worker_set.remote_workers])
    else:
        batches = [worker_set.local_worker.sample()]
    if isinstance(batches[0], MultiAgentBatch):
        return MultiAgentBatch.concat_samples(batches)
    return concat_samples(batches)


def collect_metrics(worker_set: WorkerSet) -> Dict[str, Any]:
    if worker_set.remote_workers:
        metrics = rt.get([w.get_metrics.remote()
                          for w in worker_set.remote_workers])
    else:
        metrics = [worker_set.local_worker.get_metrics()]
    rewards: List[float] = []
    lens: List[int] = []
    steps = 0
    for m in metrics:
        rewards += m["episode_rewards"]
        lens += m["episode_lens"]
        steps += m["num_env_steps"]
    return {
        "episode_reward_mean": float(np.mean(rewards)) if rewards else
        float("nan"),
        "episode_reward_max": float(np.max(rewards)) if rewards else
        float("nan"),
        "episode_reward_min": float(np.min(rewards)) if rewards else
        float("nan"),
        "episode_len_mean": float(np.mean(lens)) if lens else float("nan"),
        "episodes_this_iter": len(rewards),
        "num_env_steps_sampled": steps,
    }
