"""ES: evolution strategies (OpenAI-ES style derivative-free RL) (port of
``ray_tpu/rllib/algorithms/es.py``).

Reference: ``rllib/algorithms/es/`` — per iteration, sample antithetic
parameter perturbations, evaluate each as a full episode on the rollout
workers (embarrassingly parallel via framework tasks), then update θ
along the fitness-weighted average of the noise (rank-normalized).  No
backprop: the learner is numpy perturbation/update math, a copy of the
reference's.

θ is the Q-net's params flattened in the reference's leaf order (dict
keys sorted, as ``jax.tree_util.tree_leaves`` walks them:
``tx.tree_leaves``), so one θ is the same network in both packages.  The
episodes are tasks of the port's runtime that build the network on the
CPU, ``device="cpu"`` passed explicitly: a plain task's worker sees no
card.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.parallel import transforms as tx
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import create_env


def _flatten(params) -> np.ndarray:
    return np.concatenate([t.detach().cpu().numpy().ravel()
                           for t in tx.tree_leaves(params)])


def _unflatten(flat: np.ndarray, params):
    """``flat`` cut into ``params``'s leaves in their tree order, as
    float32 tensors on each leaf's device."""
    out, off = [], 0
    for leaf in tx.tree_leaves(params):
        n = leaf.numel()
        out.append(torch.from_numpy(np.array(
            flat[off:off + n], np.float32).reshape(leaf.shape)).to(
                leaf.device))
        off += n
    it = iter(out)
    return tx.tree_map(lambda _: next(it), params)


@rt.remote
def _es_rollout(env_spec, env_config, model_config_dict, flat_params,
                deterministic_env_seed: int, device: str = "cpu") -> float:
    """One episode with the given flat parameters; returns total reward."""
    cfg = models.ModelConfig(**model_config_dict)
    dev = torch.device(device)
    template = models.init_q_net(
        torch.Generator(device=dev).manual_seed(0), cfg)
    params = _unflatten(flat_params, template)
    n_layers = len(cfg.hiddens) + 1
    env = create_env(env_spec, env_config)
    obs, _ = env.reset(seed=deterministic_env_seed)
    total, done = 0.0, False
    with torch.no_grad():
        while not done:
            logits = models.q_net_apply(
                params, torch.as_tensor(np.asarray(obs, np.float32),
                                        device=dev)[None], n_layers)
            act = int(torch.argmax(logits[0]))
            obs, r, term, trunc, _ = env.step(act)
            total += float(r)
            done = term or trunc
    return total


class ESConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ES)
        self._cfg.update({
            "episodes_per_batch": 16,     # perturbation pairs per iter
            "noise_std": 0.1,
            "step_size": 0.02,
            "fcnet_hiddens": (32, 32),
            "num_workers": 0,             # rollouts are tasks, not actors
        })


class ES(Algorithm):
    _default_config_cls = ESConfig

    def setup(self, config: Dict[str, Any]) -> None:
        env = create_env(config["env"], config.get("env_config"))
        hiddens = tuple(config["fcnet_hiddens"])
        self.model_config = models.ModelConfig(
            obs_dim=models.flat_obs_dim(env.observation_space),
            num_outputs=int(env.action_space.n), hiddens=hiddens)
        seed = config.get("seed") or 0
        self.theta = _flatten(models.init_q_net(
            torch.Generator(device="cpu").manual_seed(seed),
            self.model_config))
        self._rng = np.random.default_rng(seed)
        self._iter = 0

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n_pairs = int(cfg["episodes_per_batch"])
        std = float(cfg["noise_std"])
        dim = len(self.theta)
        noise = self._rng.standard_normal((n_pairs, dim)).astype(np.float32)
        self._iter += 1
        env_seed = 10_000 + self._iter  # common seed: antithetic pairs
        # fan out 2*n_pairs episodes as parallel tasks (+ and - directions)
        mc = self.model_config.__dict__
        refs = []
        for i in range(n_pairs):
            for sign in (1.0, -1.0):
                refs.append(_es_rollout.remote(
                    cfg["env"], cfg.get("env_config"), mc,
                    self.theta + sign * std * noise[i], env_seed + i,
                    device="cpu"))
        rewards = np.asarray(rt.get(refs), np.float32).reshape(n_pairs, 2)

        # rank-normalize fitness (robust to reward scale), antithetic diff
        flat = rewards.ravel()
        ranks = np.empty(len(flat), np.float32)
        ranks[flat.argsort()] = np.linspace(-0.5, 0.5, len(flat))
        ranks = ranks.reshape(n_pairs, 2)
        advantage = ranks[:, 0] - ranks[:, 1]
        grad = (advantage[:, None] * noise).mean(0) / std
        self.theta = self.theta + float(cfg["step_size"]) * grad

        return {"episode_reward_mean": float(rewards.mean()),
                "episode_reward_max": float(rewards.max()),
                "episodes_this_iter": 2 * n_pairs,
                "theta_norm": float(np.linalg.norm(self.theta))}

    def train(self) -> Dict[str, Any]:
        result = super().train()
        # ES samples via tasks, not the worker set — surface its episode
        # stats at the top level where tune/tests expect them
        result.update(result["info"])
        return result

    # ES has no rollout-worker set; evaluation runs the greedy policy
    def evaluate(self, episodes: int = 3) -> Dict[str, Any]:
        ref = [_es_rollout.remote(self.config["env"],
                                  self.config.get("env_config"),
                                  self.model_config.__dict__, self.theta,
                                  20_000 + i, device="cpu")
               for i in range(episodes)]
        rs = rt.get(ref)
        return {"evaluation_reward_mean": float(np.mean(rs))}
