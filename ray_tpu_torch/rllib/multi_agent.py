"""Multi-agent rollout worker: policy map + per-agent experience routing
(a copy of ``ray_tpu/rllib/multi_agent.py`` on the port's ``Policy``).

Reference: RLlib's multi-agent support in ``rllib/evaluation/
rollout_worker.py`` + ``rllib/policy/policy_map.py``: a worker holds a
MAP of policies, a ``policy_mapping_fn(agent_id)`` routes each agent's
experience to one policy, and sampling yields a ``MultiAgentBatch`` of
per-policy ``SampleBatch``es.  PPO trains one learner per policy.

Config shape (reference parity)::

    config["multiagent"] = {
        "policies": {pid: (policy_cls|None, obs_space|None,
                           act_space|None, config|None), ...}
                    # or just {pid: None} for all-defaults,
        "policy_mapping_fn": lambda agent_id, **kw: pid,
    }
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib import env as env_lib
from ray_tpu_torch.rllib.policy import Policy, compute_gae
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, EPS_ID, MultiAgentBatch, NEXT_OBS, OBS, REWARDS, SampleBatch,
    TERMINATEDS, TRUNCATEDS, concat_samples)


def _policy_spec(spec):
    if spec is None:
        return None, None, None, {}
    if isinstance(spec, (tuple, list)):
        cls, obs_sp, act_sp, conf = (list(spec) + [None] * 4)[:4]
        return cls, obs_sp, act_sp, (conf or {})
    return None, None, None, dict(spec)


class MultiAgentRolloutWorker:
    """Steps one MultiAgentEnv; same external surface as RolloutWorker
    (``sample``/``get_weights``/``set_weights``/``get_metrics``), but
    weights and batches are keyed by policy id."""

    def __init__(self, config: Dict[str, Any], worker_index: int = 0):
        self.config = dict(config)
        self.worker_index = worker_index
        seed = config.get("seed")
        if seed is not None:
            seed = int(seed) + 1000 * worker_index
            np.random.seed(seed)
        self.env = env_lib.create_env(config["env"],
                                      config.get("env_config"))
        if not isinstance(self.env, env_lib.MultiAgentEnv):
            raise ValueError("multiagent config requires a MultiAgentEnv")
        ma = config["multiagent"]
        self.mapping = ma["policy_mapping_fn"]
        self.policies: Dict[str, Policy] = {}
        for j, (pid, spec) in enumerate(sorted(ma["policies"].items())):
            cls, obs_sp, act_sp, pconf = _policy_spec(spec)
            cls = cls or config.get("policy_class") or Policy
            merged = dict(config)
            merged.update(pconf)
            merged["seed"] = (seed or 0) + 17 + j
            self.policies[pid] = cls(
                obs_sp or self.env.observation_space,
                act_sp or self.env.action_space, merged)
        self.fragment_length = int(config.get("rollout_fragment_length", 200))
        self.gamma = float(config.get("gamma", 0.99))
        self.lam = float(config.get("lambda", 0.95))
        self._obs, _ = self.env.reset(seed=seed)
        self._eps_id = 1_000_000 * worker_index
        # per-agent open-episode column buffers
        self._buf: Dict[str, Dict[str, list]] = collections.defaultdict(
            lambda: collections.defaultdict(list))
        self._ep_reward = 0.0
        self._ep_len = 0
        self._completed: collections.deque = collections.deque(maxlen=100)
        self._total_steps = 0

    # ------------------------------------------------------------- sampling
    def _agent_pid(self, aid: str) -> str:
        try:
            return self.mapping(aid)
        except TypeError:
            return self.mapping(aid, None)

    def _finalize_agent(self, aid: str, terminated: bool) -> Optional[SampleBatch]:
        cols = self._buf.pop(aid, None)
        if not cols or not cols[OBS]:
            return None
        pid = self._agent_pid(aid)
        batch = SampleBatch({k: np.asarray(v) for k, v in cols.items()})
        last_value = 0.0 if terminated else float(
            self.policies[pid].value(batch[NEXT_OBS][-1:])[0])
        return pid, compute_gae(batch, last_value, self.gamma, self.lam)

    def sample(self) -> MultiAgentBatch:
        out: Dict[str, List[SampleBatch]] = collections.defaultdict(list)
        env_steps = 0
        for _ in range(self.fragment_length):
            # group live agents by policy, act batched per policy
            by_pid: Dict[str, List[str]] = collections.defaultdict(list)
            for aid in self._obs:
                by_pid[self._agent_pid(aid)].append(aid)
            action_dict: Dict[str, Any] = {}
            extras_by_agent: Dict[str, Dict[str, np.ndarray]] = {}
            for pid, aids in by_pid.items():
                obs = np.stack([self._obs[a] for a in aids])
                actions, extras = self.policies[pid].compute_actions(obs)
                for i, a in enumerate(aids):
                    action_dict[a] = actions[i]
                    extras_by_agent[a] = {k: v[i] for k, v in extras.items()}
            prev_obs = self._obs
            obs, rews, terms, truncs, _ = self.env.step(action_dict)
            env_steps += 1
            self._total_steps += 1
            for aid in action_dict:
                b = self._buf[aid]
                b[OBS].append(prev_obs[aid])
                b[ACTIONS].append(action_dict[aid])
                b[REWARDS].append(np.float32(rews.get(aid, 0.0)))
                term = bool(terms.get(aid, False))
                trunc = bool(truncs.get(aid, False))
                # true successor obs: present unless the agent just ended
                b[NEXT_OBS].append(obs.get(aid, prev_obs[aid]))
                b[TERMINATEDS].append(term)
                b[TRUNCATEDS].append(trunc)
                b[EPS_ID].append(np.int64(self._eps_id))
                for k, v in extras_by_agent[aid].items():
                    b[k].append(v)
                self._ep_reward += rews.get(aid, 0.0)
                if term or trunc:
                    fin = self._finalize_agent(aid, terminated=term)
                    if fin:
                        out[fin[0]].append(fin[1])
            self._ep_len += 1
            if terms.get("__all__") or truncs.get("__all__"):
                # a global TRUNCATION (time limit) must bootstrap V(s') for
                # agents without their own terminal flag, same convention
                # as the single-agent worker; terminated=0-bootstrap only
                # on a true global terminal
                all_terminal = bool(terms.get("__all__"))
                for aid in list(self._buf):
                    fin = self._finalize_agent(aid, terminated=all_terminal)
                    if fin:
                        out[fin[0]].append(fin[1])
                self._completed.append((self._ep_reward, self._ep_len))
                self._ep_reward, self._ep_len = 0.0, 0
                self._eps_id += 1
                self._obs, _ = self.env.reset()
            else:
                self._obs = obs
        # fragment cut: close open per-agent episodes with a bootstrap
        for aid in list(self._buf):
            fin = self._finalize_agent(aid, terminated=False)
            if fin:
                out[fin[0]].append(fin[1])
        self._eps_id += 1  # new ids so the next fragment splits cleanly
        return MultiAgentBatch(
            {pid: concat_samples(v) for pid, v in out.items()}, env_steps)

    def sample_with_weights(self, weights: Optional[dict]) -> MultiAgentBatch:
        if weights is not None:
            self.set_weights(weights)
        return self.sample()

    # ------------------------------------------------------------- plumbing
    def get_weights(self) -> dict:
        return {pid: p.get_weights() for pid, p in self.policies.items()}

    def set_weights(self, weights: dict) -> None:
        for pid, w in weights.items():
            if pid in self.policies:
                self.policies[pid].set_weights(w)

    def get_metrics(self) -> Dict[str, Any]:
        eps = list(self._completed)
        self._completed.clear()
        return {"episode_rewards": [r for r, _ in eps],
                "episode_lens": [l for _, l in eps],
                "num_env_steps": self._total_steps}

    def get_spaces(self):
        return (self.env.observation_space, self.env.action_space)

    @property
    def policy(self):  # single-policy convenience (evaluate(), etc.)
        return next(iter(self.policies.values()))
