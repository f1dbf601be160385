"""Offline RL data plane: JSON episode logs → training batches (a copy of
``ray_tpu/rllib/offline.py``, JAX-free there too, on the port's
``SampleBatch`` and env registry; a directory written by either package
reads the same in the other).

Reference: ``rllib/offline/`` (``JsonWriter``/``JsonReader``,
``input_``/``output`` config) — experiences recorded as JSON-lines files
that offline algorithms (BC/MARWIL) train from without touching an env.

Format: one JSON object per line, one EPISODE per object::

    {"obs": [[...], ...], "actions": [...], "rewards": [...],
     "terminated": true}

``OfflineData`` loads every episode, computes discounted monte-carlo
returns (the MARWIL target), and serves uniform transition minibatches
as numpy column dicts; the learner uploads a whole minibatch for one
update.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, NEXT_OBS, OBS, REWARDS, SampleBatch, TERMINATEDS, TRUNCATEDS)


class JsonWriter:
    """Append SampleBatches as episode rows (reference: ``JsonWriter``)."""

    def __init__(self, path: str, max_file_size: int = 64 * 1024 * 1024):
        os.makedirs(path, exist_ok=True)
        self._dir = path
        self._max = max_file_size
        self._idx = 0
        self._f = None

    def _file(self):
        if self._f is None or self._f.tell() > self._max:
            if self._f:
                self._f.close()
            self._f = open(os.path.join(
                self._dir, f"output-{self._idx:05d}.json"), "a")
            self._idx += 1
        return self._f

    def write(self, batch: SampleBatch) -> None:
        for ep in batch.split_by_episode():
            terminated = bool(ep[TERMINATEDS][-1])
            row = {
                "obs": np.asarray(ep[OBS]).tolist(),
                "actions": np.asarray(ep[ACTIONS]).tolist(),
                "rewards": np.asarray(ep[REWARDS], np.float64).tolist(),
                "terminated": terminated,
            }
            if not terminated and NEXT_OBS in ep:
                # truncated / fragment-cut: keep the final observation
                # so readers can BOOTSTRAP the return instead of
                # pretending the episode's value ended at truncation
                row["final_obs"] = np.asarray(ep[NEXT_OBS][-1]).tolist()
            f = self._file()
            f.write(json.dumps(row) + "\n")
            f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class JsonReader:
    """Iterate episode rows from JSON-lines files (reference:
    ``JsonReader``)."""

    def __init__(self, path: str):
        import glob
        if os.path.isdir(path):
            self._files = sorted(glob.glob(os.path.join(path, "*.json")))
        else:
            self._files = [path]
        if not self._files:
            raise FileNotFoundError(f"no offline data under {path!r}")

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for f in self._files:
            with open(f) as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        yield json.loads(line)


class OfflineData:
    """All episodes in memory as flat transition columns + MC returns.

    Truncated episodes (``terminated: false``) carry biased zero-tail
    returns unless bootstrapped: ``rebuild_returns(value_fn)`` redoes
    the return computation with V(final_obs) seeding the accumulator —
    MARWIL refreshes this against its own improving value head
    (reference: postprocessing bootstraps truncated trajectories with
    the current policy's value estimate)."""

    def __init__(self, path: str, gamma: float = 0.99):
        self.gamma = float(gamma)
        self._ep_rewards: List[np.ndarray] = []
        self._ep_truncated: List[bool] = []
        self._final_obs: List[Optional[np.ndarray]] = []
        obs: List[np.ndarray] = []
        actions: List[np.ndarray] = []
        self.episodes = 0
        for row in JsonReader(path):
            obs.append(np.asarray(row["obs"], np.float32))
            actions.append(np.asarray(row["actions"]))
            self._ep_rewards.append(np.asarray(row["rewards"], np.float32))
            truncated = not bool(row.get("terminated", True))
            self._ep_truncated.append(truncated)
            fo = row.get("final_obs")
            self._final_obs.append(
                np.asarray(fo, np.float32) if fo is not None else None)
            self.episodes += 1
        if not obs:
            raise ValueError(f"offline dataset at {path!r} is empty")
        self.obs = np.concatenate(obs)
        self.actions = np.concatenate(actions)
        self.count = len(self.obs)
        self.rebuild_returns(None)

    def rebuild_returns(self, value_fn=None) -> None:
        """Recompute MC returns; ``value_fn(obs_batch) -> values`` seeds
        truncated episodes' accumulators (one batched call)."""
        boots = np.zeros(self.episodes, np.float32)
        if value_fn is not None:
            idx = [i for i in range(self.episodes)
                   if self._ep_truncated[i] and
                   self._final_obs[i] is not None]
            if idx:
                vals = np.asarray(value_fn(
                    np.stack([self._final_obs[i] for i in idx])))
                boots[idx] = vals.astype(np.float32)
        rets = []
        for i, r in enumerate(self._ep_rewards):
            ret = np.zeros_like(r)
            acc = float(boots[i])
            for t in range(len(r) - 1, -1, -1):
                acc = r[t] + self.gamma * acc
                ret[t] = acc
            rets.append(ret)
        self.returns = np.concatenate(rets)

    def minibatch(self, rng: np.random.Generator,
                  size: int) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.count, size=min(size, self.count))
        return {OBS: self.obs[idx], ACTIONS: self.actions[idx],
                "returns": self.returns[idx]}


def record_rollouts(policy, env_name: str, path: str, *,
                    episodes: int = 20, env_config: Optional[dict] = None,
                    explore: bool = True, seed: int = 0) -> int:
    """Roll a policy in an env and write the episodes as offline data
    (the test/demo producer; reference: ``rllib rollout --out``)."""
    from ray_tpu_torch.rllib import env as env_lib
    e = env_lib.create_env(env_name, env_config)
    w = JsonWriter(path)
    steps = 0
    for ep in range(episodes):
        o, _ = e.reset(seed=seed + ep)
        cols = {OBS: [], ACTIONS: [], REWARDS: [], NEXT_OBS: [],
                TERMINATEDS: [], TRUNCATEDS: [], "eps_id": []}
        done = False
        while not done:
            a, _ = policy.compute_single_action(
                np.asarray(o, np.float32), explore=explore)
            o2, r, term, trunc, _ = e.step(a)
            cols[OBS].append(np.asarray(o, np.float32))
            cols[ACTIONS].append(a)
            cols[REWARDS].append(float(r))
            cols[NEXT_OBS].append(np.asarray(o2, np.float32))
            cols[TERMINATEDS].append(bool(term))
            cols[TRUNCATEDS].append(bool(trunc))
            cols["eps_id"].append(ep)
            o = o2
            done = term or trunc
            steps += 1
        w.write(SampleBatch({k: np.asarray(v) for k, v in cols.items()}))
    w.close()
    return steps
