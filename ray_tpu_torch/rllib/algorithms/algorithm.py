"""Algorithm base: the train()/training_step() driver (port of
``ray_tpu/rllib/algorithms/algorithm.py``).

Reference: ``rllib/algorithms/algorithm.py`` — ``Algorithm.train()`` wraps
one ``training_step()`` with metric collection, iteration bookkeeping,
and checkpointing.  ``AlgorithmConfig`` keeps the reference's fluent
builder surface (``.environment().rollouts().training()``) over a plain
dict.  The device is the config key ``device``, set through
``.resources(device=...)``: ``None`` (the default) is the card, ``"cpu"``
the CPU; it places the local worker's policy, and with it the learner,
while remote rollout workers run on the CPU (``evaluation.WorkerSet``).
``restore`` reaches the remotes through ``set_weights``, and ``stop``
kills them.  Checkpoints are pickles of numpy weights in the reference's
layout.
"""

from __future__ import annotations

import copy
import os
import pickle
import time
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.parallel import transforms as tx
from ray_tpu_torch.rllib.evaluation import WorkerSet, collect_metrics


class AlgorithmConfig:
    """Fluent config builder.  ``.to_dict()`` or pass directly to an
    Algorithm class; unknown keys flow through to workers/policies."""

    def __init__(self, algo_class: Optional[type] = None):
        self.algo_class = algo_class
        self._cfg: Dict[str, Any] = {
            "env": None, "env_config": {},
            "num_workers": 0, "num_envs_per_worker": 1,
            "rollout_fragment_length": 200, "num_cpus_per_worker": 1,
            "gamma": 0.99, "lr": 5e-4, "train_batch_size": 4000,
            "fcnet_hiddens": (64, 64), "seed": None, "device": None,
        }

    # Fluent sections (reference names).
    def environment(self, env=None, *, env_config=None, **kw):
        if env is not None:
            self._cfg["env"] = env
        if env_config is not None:
            self._cfg["env_config"] = env_config
        self._cfg.update(kw)
        return self

    def rollouts(self, **kw):
        self._cfg.update(kw)
        return self

    env_runners = rollouts

    def training(self, **kw):
        self._cfg.update(kw)
        return self

    def resources(self, **kw):
        self._cfg.update(kw)
        return self

    def debugging(self, *, seed=None, **kw):
        if seed is not None:
            self._cfg["seed"] = seed
        self._cfg.update(kw)
        return self

    def multi_agent(self, *, policies=None, policy_mapping_fn=None,
                    **kw) -> "AlgorithmConfig":
        """Reference: ``AlgorithmConfig.multi_agent(policies=...,
        policy_mapping_fn=...)``.  ``policies`` may be a set/list of ids
        (all-default policies) or {pid: (cls, obs_space, act_space,
        config)} specs."""
        ma = dict(self._cfg.get("multiagent") or {})
        if policies is not None:
            if isinstance(policies, (set, list, tuple)):
                policies = {pid: None for pid in policies}
            ma["policies"] = dict(policies)
        if policy_mapping_fn is not None:
            ma["policy_mapping_fn"] = policy_mapping_fn
        ma.update(kw)
        self._cfg["multiagent"] = ma
        return self

    def framework(self, *_a, **_kw):  # torch-only; accepted for API parity
        return self

    def update(self, other: Dict[str, Any]) -> "AlgorithmConfig":
        self._cfg.update(other)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._cfg)

    def build(self, env=None) -> "Algorithm":
        if env is not None:
            self._cfg["env"] = env
        cls = self.algo_class or Algorithm
        return cls(config=self)

    def __getitem__(self, key):
        return self._cfg[key]


class Algorithm:
    """Drives training: subclasses override ``default_config`` and
    ``training_step``."""

    _default_config_cls = AlgorithmConfig
    # Algorithms that can consume a MultiAgentBatch opt in; everything
    # else must fail loudly at build time, not with an obscure TypeError
    # deep inside training_step.
    _supports_multi_agent = False

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return cls._default_config_cls(cls)

    def __init__(self, config: Any = None, env: Any = None, **overrides):
        base = self.get_default_config().to_dict()
        if isinstance(config, AlgorithmConfig):
            config = config.to_dict()
        # normalize the worker-count alias per user-supplied dict (the
        # reference spells it both ways across versions; WorkerSet reads
        # "num_workers"; an explicit num_workers in the SAME dict wins)
        def _normalize(d):
            if d and "num_rollout_workers" in d:
                d = dict(d)
                d.setdefault("num_workers", d["num_rollout_workers"])
                del d["num_rollout_workers"]
            return d

        base.update(_normalize(config) or {})
        base.update(_normalize(overrides))
        if env is not None:
            base["env"] = env
        if base.get("env") is None:
            raise ValueError("no env specified")
        if base.get("multiagent") and not self._supports_multi_agent:
            raise NotImplementedError(
                f"{type(self).__name__} does not support multi-agent "
                f"training (PPO does); remove the multi_agent(...) config")
        self.config = base
        self.iteration = 0
        self._timesteps_total = 0
        self._time_total = 0.0
        self.workers = WorkerSet(base)
        self.setup(base)

    def setup(self, config: Dict[str, Any]) -> None:
        """Algorithm-specific state (learner jit fns, buffers)."""

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def train(self) -> Dict[str, Any]:
        start = time.perf_counter()
        info = self.training_step() or {}
        elapsed = time.perf_counter() - start
        self.iteration += 1
        self._time_total += elapsed
        metrics = collect_metrics(self.workers)
        self._timesteps_total = metrics.pop("num_env_steps_sampled")
        result = {
            "training_iteration": self.iteration,
            "timesteps_total": self._timesteps_total,
            "time_this_iter_s": elapsed,
            "time_total_s": self._time_total,
            **metrics,
            "info": info,
        }
        # Tune-compatible aliases (reference result dict carries both).
        result["env_runners"] = {
            "episode_return_mean": metrics.get("episode_reward_mean")}
        return result

    def evaluate(self, num_episodes: int = 5) -> Dict[str, Any]:
        """Greedy-policy rollouts on a fresh local env."""
        from ray_tpu_torch.rllib import env as env_lib
        e = env_lib.create_env(self.config["env"],
                               self.config.get("env_config"))
        pol = self.workers.local_worker.policy
        rewards = []
        for ep in range(num_episodes):
            obs, _ = e.reset(seed=10_000 + ep)
            total, done = 0.0, False
            while not done:
                a, _ = pol.compute_single_action(obs, explore=False)
                obs, r, term, trunc, _ = e.step(a)
                total += float(r)
                done = term or trunc
            rewards.append(total)
        return {"evaluation": {
            "episode_reward_mean": sum(rewards) / len(rewards)}}

    def get_policy(self):
        return self.workers.local_worker.policy

    def get_weights(self) -> dict:
        return self.workers.local_worker.get_weights()

    def set_weights(self, weights: dict) -> None:
        self.workers.local_worker.set_weights(weights)
        self.workers.sync_weights()

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "wb") as f:
            pickle.dump({
                "weights": self.get_weights(),
                "iteration": self.iteration,
                "timesteps_total": self._timesteps_total,
                "config": {k: v for k, v in self.config.items()
                           if _picklable(v)},
                "extra_state": self.get_extra_state(),
            }, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.set_weights(state["weights"])
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]
        self.set_extra_state(state.get("extra_state"))

    def get_extra_state(self) -> Any:
        return None

    def set_extra_state(self, state: Any) -> None:
        pass

    def stop(self) -> None:
        """Kills the remote rollout workers."""
        self.workers.stop()


def _picklable(v) -> bool:
    try:
        pickle.dumps(v)
        return True
    except Exception:  # noqa: BLE001
        return False


def grads_with_aux(loss_fn, params, *args):
    """``jax.grad(loss_fn, has_aux=True)(params, *args)`` on a dict of
    tensors: ``loss_fn`` returns (loss, aux); returns (grads shaped as
    ``params``, aux).  A leaf the loss does not reach gets zeros."""
    leaves = tx.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, aux = loss_fn(params, *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(grads)
    aux = tuple(a.detach() for a in aux) if isinstance(aux, tuple) \
        else aux.detach()
    return tx.tree_map(lambda _: next(it), params), aux


@torch.no_grad()
def apply_updates(params, updates) -> None:
    """``optax.apply_updates``, in place (the policy's tensors are the
    learner's state)."""
    tx.tree_map(lambda p, u: p.add_(u), params, updates)
