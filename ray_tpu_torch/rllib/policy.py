"""Policy: network + action distribution (port of
``ray_tpu/rllib/policy.py``).

Reference: ``rllib/policy/policy.py`` / ``torch_policy.py`` —
``compute_actions`` drives sampling, the algorithms' learners drive
training, and weights move between learner and rollout workers as numpy
dicts in the reference's layout (``models.params_to_numpy``).

``compute_actions`` is one device call an env step: the observations go
up in one copy (a uint8 frame stays uint8), the network, the
sample and its log-probability run on the device, and actions, logp,
dist inputs and values come back in ONE copy.  Action sampling draws
from a ``torch.Generator`` on the policy's device, seeded from the
config's seed.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.parallel import transforms as tx
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.sample_batch import (
    ACTION_DIST_INPUTS, ACTION_LOGP, ADVANTAGES, REWARDS, SampleBatch,
    TERMINATEDS, VALUE_TARGETS, VF_PREDS)


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host column on ``device`` in one copy: floating columns as
    float32 (the reference's ``jnp.asarray(obs, jnp.float32)``), every
    other dtype as it is, so a uint8 frame uploads as uint8 and the nets
    cast it on the device."""
    x = np.asarray(x)
    if x.dtype.kind == "f":
        x = x.astype(np.float32, copy=False)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


class Policy:
    """Actor-critic policy.  ``config['device']``: ``None`` (the
    default) is the card, ``"cpu"`` the CPU."""

    def __init__(self, observation_space, action_space,
                 config: Optional[dict] = None):
        config = config or {}
        self.observation_space = observation_space
        self.action_space = action_space
        self.config = config
        self.device = resolve_device(config.get("device"))
        self.dist_class = models.get_dist_class(action_space)
        self.model_config = models.make_model_config(
            observation_space, action_space, config)
        seed = config.get("seed", 0)
        # catalog: MLP towers for flat obs, shared Nature-CNN torso +
        # linear heads for rank-3 (pixel) obs
        init_gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params, self._apply = models.make_actor_critic(
            init_gen, self.model_config)
        self._seed = seed + 1
        self._gen = torch.Generator(device=self.device).manual_seed(
            self._seed)

    def apply_fn(self, params, obs):
        """(dist_inputs, values) — used by algorithm loss fns."""
        return self._apply(params, obs)

    def to(self, device) -> None:
        """Moves the params (and the action generator, reseeded) to
        ``device``: IMPALA's ``learner_device: "cpu"``."""
        dev = resolve_device(device)
        self.params = tx.tree_map(lambda t: t.to(dev), self.params)
        self.device = dev
        self._gen = torch.Generator(device=dev).manual_seed(self._seed)

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, explore: bool = True
                        ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        x = to_device(obs, self.device)
        inputs, values = self._apply(self.params, x)
        B = inputs.shape[0]
        if explore:
            actions = self.dist_class.sample(inputs, self._gen)
            logp = self.dist_class.logp(inputs, actions)
            cols = (actions, logp, inputs, values)
        else:
            actions = self.dist_class.deterministic(inputs)
            cols = (actions, inputs, values)
        # one device-to-host copy for every output
        cols = [c.reshape(B, -1).to(torch.float32) for c in cols]
        host = torch.cat(cols, dim=1).cpu().numpy()
        parts = np.split(host, np.cumsum([c.shape[1] for c in cols])[:-1],
                         axis=1)
        if self.dist_class is models.Categorical:
            acts = parts[0][:, 0].astype(np.int32)
        else:
            acts = parts[0].reshape(actions.shape)
        if explore:
            extras = {ACTION_LOGP: parts[1][:, 0],
                      ACTION_DIST_INPUTS: parts[2],
                      VF_PREDS: parts[3][:, 0]}
        else:
            extras = {ACTION_DIST_INPUTS: parts[1],
                      VF_PREDS: parts[2][:, 0]}
        return acts, extras

    def compute_single_action(self, obs: np.ndarray, explore: bool = True):
        a, extras = self.compute_actions(obs[None], explore)
        return a[0], {k: v[0] for k, v in extras.items()}

    @torch.no_grad()
    def value(self, obs: np.ndarray) -> np.ndarray:
        _, values = self._apply(self.params, to_device(obs, self.device))
        return values.cpu().numpy()

    def get_weights(self) -> Dict[str, Any]:
        return models.params_to_numpy(self.params)

    def set_weights(self, weights: Dict[str, Any]) -> None:
        self.params = models.params_from_numpy(weights, self.model_config,
                                               self.device)


def compute_gae(batch: SampleBatch, last_value: float, gamma: float,
                lam: float) -> SampleBatch:
    """GAE(λ) advantages + value targets for one episode fragment (a copy
    of the reference's).

    Reference: ``rllib/evaluation/postprocessing.py::compute_advantages``.
    Runs in numpy on the rollout worker (tiny, latency-bound).
    ``last_value`` bootstraps truncated fragments; 0 for terminated
    episodes.
    """
    rewards = batch[REWARDS]
    vf = batch[VF_PREDS]
    terminated = bool(batch[TERMINATEDS][-1]) if len(batch) else False
    bootstrap = 0.0 if terminated else float(last_value)
    vf_next = np.append(vf[1:], bootstrap).astype(np.float32)
    deltas = rewards + gamma * vf_next - vf
    adv = np.zeros_like(rewards)
    acc = 0.0
    for t in range(len(rewards) - 1, -1, -1):
        acc = deltas[t] + gamma * lam * acc
        adv[t] = acc
    batch[ADVANTAGES] = adv.astype(np.float32)
    batch[VALUE_TARGETS] = (adv + vf).astype(np.float32)
    return batch
