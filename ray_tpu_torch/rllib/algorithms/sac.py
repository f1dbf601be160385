"""SAC: soft actor-critic for continuous control (port of
``ray_tpu/rllib/algorithms/sac.py``).

Reference: ``rllib/algorithms/sac/`` — off-policy maximum-entropy RL: a
squashed-Gaussian actor, twin Q critics with target networks (clipped
double-Q), and automatic entropy-temperature tuning against a target
entropy of ``-dim(A)``.

The learner is the reference's update as a plain function on tensors
(``SAC._update``): critics, then the actor against the updated critics,
then the temperature with the actor step's log-probabilities, then the
Polyak sync, each with its own Adam state.  It updates the params and
the Adam states in place and returns ``(alpha, entropy)`` as one device
tensor.  Its two Gaussian draws (the next-state actions, the actor
step) come in as arguments; ``training_step`` draws them from the
algorithm's ``torch.Generator`` (seeded from the config), so a test can
feed it the draws JAX made.  The log-probability is the reference's
formula, ``1e-6`` inside the tanh Jacobian's log included
(``tanh_log_det``), not ``torch.distributions.TanhTransform``'s.

``save`` / ``restore`` keep the reference's contract: the policy's
weights and ``get_extra_state()``, which SAC does not override, so the
critics, their targets and the temperature are not in a checkpoint.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.parallel import transforms as tx
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.algorithms.algorithm import (
    Algorithm, AlgorithmConfig, apply_updates, grads_with_aux)
from ray_tpu_torch.rllib.algorithms.dqn import ReplayBuffer
from ray_tpu_torch.rllib.evaluation import synchronous_parallel_sample
from ray_tpu_torch.rllib.policy import to_device
from ray_tpu_torch.rllib.sample_batch import (
    ACTION_DIST_INPUTS, ACTION_LOGP, NEXT_OBS, OBS, REWARDS, TERMINATEDS,
    VF_PREDS)

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
STATS = ("alpha", "entropy")
REPLAY_KEYS = (OBS, "raw_action", REWARDS, NEXT_OBS, TERMINATEDS)


def actor_apply(params, obs, num_layers):
    """(mean, log_std clipped to [LOG_STD_MIN, LOG_STD_MAX])."""
    out = models.q_net_apply(params, obs, num_layers)  # (B, 2*act_dim)
    mean, log_std = torch.chunk(out, 2, dim=-1)
    return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)


def tanh_log_det(pre: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """``Σ log(1 − tanh(pre)² + 1e-6)``, the reference's correction (the
    SAC paper's, with its 1e-6), evaluated as XLA compiles the
    reference's expression: the constants folded first, ``(1 + 1e-6) −
    a²`` in float32.  A saturated action (a = ±1 exactly) then gives
    log(9.5367e-7), as the reference does, not log(1e-6)."""
    return torch.log((1 + 1e-6) - act ** 2).sum(-1)


def sample_squashed(params, obs, eps, num_layers):
    """Reparameterized tanh-Gaussian sample on the standard-normal draw
    ``eps`` (shaped like the mean) and its log-probability."""
    mean, log_std = actor_apply(params, obs, num_layers)
    pre = mean + torch.exp(log_std) * eps
    act = torch.tanh(pre)
    logp = (-0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))).sum(-1)
    return act, logp - tanh_log_det(pre, act)


def polyak(target, source, tau: float) -> None:
    """``(1 − tau)·t + tau·s`` into the target, in place."""
    with torch.no_grad():
        tx.tree_map(lambda t, s: t.copy_((1 - tau) * t + tau * s),
                    target, source)


def squashed_action_extras(a: np.ndarray, n_dist_inputs: int):
    """The columns a replay learner's policy gives the sampler: zeros for
    the on-policy ones (GAE stays defined), the raw tanh action for the
    buffer."""
    n = len(a)
    return {VF_PREDS: np.zeros(n, np.float32),
            ACTION_LOGP: np.zeros(n, np.float32),
            ACTION_DIST_INPUTS: np.zeros((n, n_dist_inputs), np.float32),
            "raw_action": a}


class SACPolicy:
    """Squashed-Gaussian actor for Box action spaces.  Exploration draws
    from a ``torch.Generator`` on the policy's device, seeded from the
    config's seed."""

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
            obs_dim=obs_dim, num_outputs=2 * self.act_dim, hiddens=hiddens)
        seed = config.get("seed", 0)
        self.params = models.init_q_net(
            torch.Generator(device=self.device).manual_seed(seed),
            self.model_config)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    def _scale(self, a: np.ndarray) -> np.ndarray:
        return self.low + (a + 1.0) * 0.5 * (self.high - self.low)

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, explore: bool = True):
        mean, log_std = actor_apply(self.params, to_device(obs, self.device),
                                    self._num_layers)
        if explore:
            eps = torch.randn(mean.shape, generator=self._gen,
                              device=mean.device, dtype=mean.dtype)
            mean = mean + torch.exp(log_std) * eps
        a = torch.tanh(mean).cpu().numpy()
        # env sees the scaled action; the buffer stores the raw tanh output
        return self._scale(a).astype(np.float32), \
            squashed_action_extras(a, 2 * self.act_dim)

    def compute_single_action(self, obs, explore: bool = True):
        a, extras = self.compute_actions(obs[None], explore)
        return a[0], {k: v[0] for k, v in extras.items()}

    def value(self, obs: np.ndarray) -> np.ndarray:
        # GAE bootstrap hook; unused by the SAC learner (replay-based)
        return np.zeros(len(obs), np.float32)

    def get_weights(self):
        return {"params": models.params_to_numpy(self.params)}

    def set_weights(self, weights):
        self.params = models.params_from_numpy(
            weights["params"], self.model_config, self.device)


class SACConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or SAC)
        self._cfg.update({
            "policy_class": SACPolicy,
            "actor_lr": 3e-4, "critic_lr": 3e-4, "alpha_lr": 3e-4,
            "gamma": 0.99, "tau": 0.005,
            "buffer_size": 100_000, "learning_starts": 256,
            "train_batch_size": 256, "num_sgd_per_step": 1,
            "rollout_fragment_length": 1,
            "fcnet_hiddens": (256, 256),
        })


def device_minibatch(mb, device, action: str = "raw_action"
                     ) -> Dict[str, torch.Tensor]:
    """A replay minibatch's learner columns on ``device`` (the actions
    from column ``action``), ``dones`` the terminated flags as float32."""
    out = {k: to_device(mb[k], device) for k in (OBS, action, REWARDS,
                                                 NEXT_OBS)}
    out["dones"] = to_device(mb[TERMINATEDS].astype(np.float32), device)
    return out


class SAC(Algorithm):
    _default_config_cls = SACConfig

    def setup(self, config: Dict[str, Any]) -> None:
        policy = self.workers.local_worker.policy
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
        self.q2 = models.init_q_net(gen, self.q_config)
        self.q1_t = models.clone_params(self.q1)
        self.q2_t = models.clone_params(self.q2)
        self.log_alpha = torch.zeros((), dtype=torch.float32, device=dev)
        self.buffer = ReplayBuffer(int(config["buffer_size"]),
                                   keys=REPLAY_KEYS)
        self._rng = np.random.default_rng(seed)
        self._gen = torch.Generator(device=dev).manual_seed(seed + 7)

        actor_opt = tx.adam(config["actor_lr"])
        critic_opt = tx.adam(config["critic_lr"])
        alpha_opt = tx.adam(config["alpha_lr"])
        self._actor_state = actor_opt.init(policy.params)
        self._critic_state = critic_opt.init({"q1": self.q1, "q2": self.q2})
        self._alpha_state = alpha_opt.init({"log_alpha": self.log_alpha})

        gamma = float(config["gamma"])
        tau = float(config["tau"])
        target_entropy = -float(act_dim)
        a_layers = policy._num_layers

        def q_apply(qp, obs, act):
            return models.q_net_apply(
                qp, torch.cat([obs, act], -1), q_layers)[:, 0]

        def update(actor_p, q1, q2, q1_t, q2_t, log_alpha, actor_s,
                   critic_s, alpha_s, mb, eps_next, eps_actor):
            with torch.no_grad():
                alpha = torch.exp(log_alpha)
                # critics: clipped double-Q against the entropy-regularized
                # bootstrap target
                next_a, next_logp = sample_squashed(
                    actor_p, mb[NEXT_OBS], eps_next, a_layers)
                q_next = torch.minimum(q_apply(q1_t, mb[NEXT_OBS], next_a),
                                       q_apply(q2_t, mb[NEXT_OBS], next_a))
                target = mb[REWARDS] + gamma * (1 - mb["dones"]) * \
                    (q_next - alpha * next_logp)

            def critic_loss(qs):
                l1 = torch.square(q_apply(qs["q1"], mb[OBS], mb["raw_action"])
                                  - target).mean()
                l2 = torch.square(q_apply(qs["q2"], mb[OBS], mb["raw_action"])
                                  - target).mean()
                return l1 + l2, ()

            critics = {"q1": q1, "q2": q2}
            c_grads, _ = grads_with_aux(critic_loss, critics)
            c_updates, _ = critic_opt.update(c_grads, critic_s, critics)
            apply_updates(critics, c_updates)

            # actor: maximize E[min Q − alpha·logp] against the updated
            # critics, alpha from the old log_alpha
            def actor_loss(ap):
                a, logp = sample_squashed(ap, mb[OBS], eps_actor, a_layers)
                q = torch.minimum(q_apply(q1, mb[OBS], a),
                                  q_apply(q2, mb[OBS], a))
                return (alpha * logp - q).mean(), logp

            a_grads, logp = grads_with_aux(actor_loss, actor_p)
            a_updates, _ = actor_opt.update(a_grads, actor_s, actor_p)
            apply_updates(actor_p, a_updates)

            # temperature: drive entropy toward the target, with the
            # pre-update actor's log-probabilities
            def alpha_loss(la):
                return (-torch.exp(la["log_alpha"])
                        * (logp + target_entropy)).mean(), ()

            la = {"log_alpha": log_alpha}
            al_grad, _ = grads_with_aux(alpha_loss, la)
            al_update, _ = alpha_opt.update(al_grad, alpha_s, la)
            apply_updates(la, al_update)

            polyak(q1_t, q1, tau)
            polyak(q2_t, q2, tau)
            return torch.stack([torch.exp(log_alpha), -logp.mean()])

        self._update = update

    def set_learner_state(self, state: Dict[str, Any]) -> None:
        """The learner's own state from numpy in the reference's layout:
        any of ``q1``, ``q2``, ``q1_t``, ``q2_t`` (param trees) and
        ``log_alpha`` (a scalar).  The Adam states are kept."""
        dev = self.workers.local_worker.policy.device
        for k in ("q1", "q2", "q1_t", "q2_t"):
            if k in state:
                setattr(self, k, models.params_from_numpy(
                    state[k], self.q_config, dev))
        if "log_alpha" in state:
            self.log_alpha.fill_(float(state["log_alpha"]))

    def get_learner_state(self) -> Dict[str, Any]:
        out = {k: models.params_to_numpy(getattr(self, k))
               for k in ("q1", "q2", "q1_t", "q2_t")}
        out["log_alpha"] = np.float32(self.log_alpha.item())
        return out

    def learn_on(self, mb: Dict[str, torch.Tensor], eps_next: torch.Tensor,
                 eps_actor: torch.Tensor) -> torch.Tensor:
        """One update of the algorithm's state on a device minibatch with
        the given draws; returns ``(alpha, entropy)`` on the device."""
        return self._update(
            self.workers.local_worker.policy.params, self.q1, self.q2,
            self.q1_t, self.q2_t, self.log_alpha, self._actor_state,
            self._critic_state, self._alpha_state, mb, eps_next, eps_actor)

    def training_step(self) -> Dict[str, Any]:
        policy = self.workers.local_worker.policy
        batch = synchronous_parallel_sample(self.workers)
        self.buffer.add_batch(batch)
        info: Dict[str, Any] = {"buffer_size": len(self.buffer)}
        if len(self.buffer) < int(self.config["learning_starts"]):
            return info
        n = int(self.config["train_batch_size"])
        shape = (n, policy.act_dim)
        stats = None
        for _ in range(int(self.config["num_sgd_per_step"])):
            mb = self.buffer.sample(n, self._rng)
            eps_next, eps_actor = (
                torch.randn(shape, generator=self._gen, device=policy.device)
                for _ in range(2))
            stats = self.learn_on(device_minibatch(mb, policy.device),
                                  eps_next, eps_actor)
        info.update(zip(STATS, stats.tolist()))       # the one host read
        return info
