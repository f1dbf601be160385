"""DDPG + TD3: deterministic-policy-gradient continuous control (port of
``ray_tpu/rllib/algorithms/ddpg.py``).

Reference: ``rllib/algorithms/ddpg/`` and ``rllib/algorithms/td3/``
(Lillicrap et al. 2016, Fujimoto et al. 2018):

- **DDPG**: deterministic tanh actor μ(s), ONE Q critic, Polyak target
  networks for both, Gaussian action-space exploration noise.
- **TD3** = DDPG + the paper's three fixes, each a config knob:
  ``twin_q`` (clipped double-Q), ``policy_delay`` (delayed actor
  updates), ``target_noise``/``target_noise_clip`` (target policy
  smoothing).

The learner is a plain function on tensors (``DDPG._update``) that
updates the params, targets and Adam states in place.  The reference
computes the actor step on every update and keeps it only on actor steps
(a ``jnp.where`` over params and Adam state); here the actor's step and
its target's sync run only on actor steps (``actor_step_due``), which
leaves the actor, its Adam state (count included) and its target exactly
as they were on the others.  With ``twin_q`` off, ``q2`` still sits in
the critic's Adam state and gets a zero gradient, so it does not move.
TD3's smoothing draw comes in as an argument; ``training_step`` draws it
from the algorithm's ``torch.Generator``.  Exploration noise is the
reference's numpy draw on the raw tanh action.

``save`` / ``restore`` checkpoint the policy's weights only, as the
reference's: the critics and targets are not in a checkpoint.
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
from ray_tpu_torch.rllib.algorithms.dqn import ReplayBuffer
from ray_tpu_torch.rllib.algorithms.sac import (
    REPLAY_KEYS, device_minibatch, polyak, squashed_action_extras)
from ray_tpu_torch.rllib.evaluation import synchronous_parallel_sample
from ray_tpu_torch.rllib.policy import to_device
from ray_tpu_torch.rllib.sample_batch import NEXT_OBS, OBS, REWARDS

STATS = ("critic_loss", "q_mean")


def actor_step_due(n_updates: int, policy_delay: int) -> bool:
    """TD3's delay: the actor steps on every ``policy_delay``-th update,
    the first included."""
    return n_updates % policy_delay == 0


class DDPGPolicy:
    """Deterministic tanh actor for Box action spaces; exploration adds
    Gaussian noise in the raw (-1, 1) action space from the reference's
    numpy generator."""

    def __init__(self, observation_space, action_space,
                 config: Optional[dict] = None):
        config = config or {}
        self.observation_space = observation_space
        self.action_space = action_space
        self.config = config
        self.device = resolve_device(config.get("device"))
        obs_dim = models.flat_obs_dim(observation_space)
        self.act_dim = int(np.prod(action_space.shape))
        self.low = np.asarray(action_space.low, np.float32)
        self.high = np.asarray(action_space.high, np.float32)
        hiddens = tuple(config.get("fcnet_hiddens", (256, 256)))
        self._num_layers = len(hiddens) + 1
        self.model_config = models.ModelConfig(
            obs_dim=obs_dim, num_outputs=self.act_dim, hiddens=hiddens)
        seed = config.get("seed", 0)
        self.params = models.init_q_net(
            torch.Generator(device=self.device).manual_seed(seed),
            self.model_config)
        self.explore_noise = float(config.get("exploration_noise", 0.1))
        self._rng = np.random.default_rng(seed + 1)

    def mu(self, params, obs: torch.Tensor) -> torch.Tensor:
        return torch.tanh(models.q_net_apply(params, obs, self._num_layers))

    def _scale(self, a: np.ndarray) -> np.ndarray:
        return self.low + (a + 1.0) * 0.5 * (self.high - self.low)

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, explore: bool = True):
        a = self.mu(self.params, to_device(obs, self.device)).cpu().numpy()
        if explore:
            a = np.clip(a + self._rng.normal(
                0.0, self.explore_noise, a.shape).astype(np.float32),
                -1.0, 1.0)
        return self._scale(a).astype(np.float32), \
            squashed_action_extras(a, self.act_dim)

    def compute_single_action(self, obs, explore: bool = True):
        a, extras = self.compute_actions(obs[None], explore)
        return a[0], {k: v[0] for k, v in extras.items()}

    def value(self, obs: np.ndarray) -> np.ndarray:
        return np.zeros(len(obs), np.float32)  # replay-based learner

    def get_weights(self):
        return {"params": models.params_to_numpy(self.params)}

    def set_weights(self, weights):
        self.params = models.params_from_numpy(
            weights["params"], self.model_config, self.device)


class DDPGConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DDPG)
        self._cfg.update({
            "policy_class": DDPGPolicy,
            "actor_lr": 1e-3, "critic_lr": 1e-3,
            "gamma": 0.99, "tau": 0.005,
            "buffer_size": 100_000, "learning_starts": 256,
            "train_batch_size": 256, "num_sgd_per_step": 1,
            "rollout_fragment_length": 1,
            "fcnet_hiddens": (256, 256),
            "exploration_noise": 0.1,
            # --- the TD3 knobs (DDPG defaults = all off) ---
            "twin_q": False,
            "policy_delay": 1,
            "target_noise": 0.0,
            "target_noise_clip": 0.5,
        })


class TD3Config(DDPGConfig):
    """DDPG + twin critics + delayed policy + target smoothing
    (reference: ``TD3Config`` defaults)."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or TD3)
        self._cfg.update({
            "twin_q": True,
            "policy_delay": 2,
            "target_noise": 0.2,
            "target_noise_clip": 0.5,
            "exploration_noise": 0.1,
        })


class DDPG(Algorithm):
    _default_config_cls = DDPGConfig

    def setup(self, config: Dict[str, Any]) -> None:
        policy: DDPGPolicy = self.workers.local_worker.policy
        dev = policy.device
        obs_dim = policy.model_config.obs_dim
        act_dim = policy.act_dim
        hiddens = tuple(config["fcnet_hiddens"])
        self.q_config = models.ModelConfig(
            obs_dim=obs_dim + act_dim, num_outputs=1, hiddens=hiddens)
        q_layers = len(hiddens) + 1
        seed = config.get("seed") or 0
        gen = torch.Generator(device=dev).manual_seed(seed + 100)
        self.q1 = models.init_q_net(gen, self.q_config)
        self.q2 = models.init_q_net(gen, self.q_config)  # unused unless twin_q
        self.actor_t = models.clone_params(policy.params)
        self.q1_t = models.clone_params(self.q1)
        self.q2_t = models.clone_params(self.q2)
        self.buffer = ReplayBuffer(int(config["buffer_size"]),
                                   keys=REPLAY_KEYS)
        self._rng = np.random.default_rng(seed)
        self._gen = torch.Generator(device=dev).manual_seed(seed + 7)
        self._n_updates = 0

        actor_opt = tx.adam(config["actor_lr"])
        critic_opt = tx.adam(config["critic_lr"])
        self._actor_state = actor_opt.init(policy.params)
        self._critic_state = critic_opt.init({"q1": self.q1, "q2": self.q2})

        gamma = float(config["gamma"])
        tau = float(config["tau"])
        twin_q = bool(config["twin_q"])
        policy_delay = int(config["policy_delay"])
        t_noise = float(config["target_noise"])
        t_clip = float(config["target_noise_clip"])
        mu = policy.mu

        def q_apply(qp, obs, act):
            return models.q_net_apply(
                qp, torch.cat([obs, act], -1), q_layers)[:, 0]

        def update(actor_p, actor_t, q1, q2, q1_t, q2_t, actor_s, critic_s,
                   n_updates, mb, noise):
            with torch.no_grad():
                # target action with TD3 smoothing noise (0 noise = DDPG)
                next_a = mu(actor_t, mb[NEXT_OBS])
                if t_noise > 0.0:
                    next_a = torch.clamp(next_a + torch.clamp(
                        t_noise * noise, -t_clip, t_clip), -1.0, 1.0)
                qn1 = q_apply(q1_t, mb[NEXT_OBS], next_a)
                q_next = torch.minimum(qn1, q_apply(q2_t, mb[NEXT_OBS],
                                                    next_a)) \
                    if twin_q else qn1
                target = mb[REWARDS] + gamma * (1 - mb["dones"]) * q_next

            def critic_loss(qs):
                loss = torch.square(q_apply(qs["q1"], mb[OBS],
                                            mb["raw_action"])
                                    - target).mean()
                if twin_q:
                    loss = loss + torch.square(
                        q_apply(qs["q2"], mb[OBS], mb["raw_action"])
                        - target).mean()
                return loss, ()

            critics = {"q1": q1, "q2": q2}
            c_grads, _ = grads_with_aux(critic_loss, critics)
            c_updates, _ = critic_opt.update(c_grads, critic_s, critics)
            apply_updates(critics, c_updates)

            # delayed deterministic-policy-gradient actor step; the actor
            # target moves only with the actor
            if actor_step_due(n_updates, policy_delay):
                def actor_loss(ap):
                    return -q_apply(q1, mb[OBS], mu(ap, mb[OBS])).mean(), ()

                a_grads, _ = grads_with_aux(actor_loss, actor_p)
                a_updates, _ = actor_opt.update(a_grads, actor_s, actor_p)
                apply_updates(actor_p, a_updates)
                polyak(actor_t, actor_p, tau)
            polyak(q1_t, q1, tau)
            polyak(q2_t, q2, tau)
            with torch.no_grad():
                return torch.stack([
                    critic_loss(critics)[0],
                    q_apply(q1, mb[OBS], mb["raw_action"]).mean()])

        self._update = update

    def set_learner_state(self, state: Dict[str, Any]) -> None:
        """The learner's own state from numpy in the reference's layout:
        any of ``q1``, ``q2``, ``q1_t``, ``q2_t``, ``actor_t`` (param
        trees).  The Adam states and the update count are kept."""
        policy = self.workers.local_worker.policy
        for k in ("q1", "q2", "q1_t", "q2_t"):
            if k in state:
                setattr(self, k, models.params_from_numpy(
                    state[k], self.q_config, policy.device))
        if "actor_t" in state:
            self.actor_t = models.params_from_numpy(
                state["actor_t"], policy.model_config, policy.device)

    def get_learner_state(self) -> Dict[str, Any]:
        return {k: models.params_to_numpy(getattr(self, k))
                for k in ("q1", "q2", "q1_t", "q2_t", "actor_t")}

    def learn_on(self, mb: Dict[str, torch.Tensor],
                 noise: Optional[torch.Tensor]) -> torch.Tensor:
        """One update of the algorithm's state on a device minibatch with
        TD3's smoothing draw; returns ``(critic_loss, q_mean)`` on the
        device."""
        stats = self._update(
            self.workers.local_worker.policy.params, self.actor_t, self.q1,
            self.q2, self.q1_t, self.q2_t, self._actor_state,
            self._critic_state, self._n_updates, mb, noise)
        self._n_updates += 1
        return stats

    def training_step(self) -> Dict[str, Any]:
        policy = self.workers.local_worker.policy
        batch = synchronous_parallel_sample(self.workers)
        self.buffer.add_batch(batch)
        info: Dict[str, Any] = {"buffer_size": len(self.buffer)}
        if len(self.buffer) < int(self.config["learning_starts"]):
            return info
        n = int(self.config["train_batch_size"])
        smooth = float(self.config["target_noise"]) > 0.0
        stats = None
        for _ in range(int(self.config["num_sgd_per_step"])):
            mb = self.buffer.sample(n, self._rng)
            noise = torch.randn((n, policy.act_dim), generator=self._gen,
                                device=policy.device) if smooth else None
            stats = self.learn_on(device_minibatch(mb, policy.device), noise)
        info.update(zip(STATS, stats.tolist()))       # the one host read
        self.workers.sync_weights()
        info["num_updates"] = self._n_updates
        return info


class TD3(DDPG):
    _default_config_cls = TD3Config
