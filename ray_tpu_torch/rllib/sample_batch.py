"""SampleBatch: the unit of experience flowing rollout workers → learner.

A copy of ``ray_tpu/rllib/sample_batch.py`` (JAX-free there too; the port
imports nothing of the reference package).  Reference:
``rllib/policy/sample_batch.py`` — a dict of column-aligned arrays with
concat / shuffle / minibatch utilities.  Columns are contiguous
``np.ndarray``s; a learner uploads the columns it needs in one copy each.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np

# Standard column names (reference: SampleBatch.OBS etc.).
OBS = "obs"
NEXT_OBS = "new_obs"
ACTIONS = "actions"
REWARDS = "rewards"
TERMINATEDS = "terminateds"
TRUNCATEDS = "truncateds"
INFOS = "infos"
EPS_ID = "eps_id"
ACTION_LOGP = "action_logp"
ACTION_DIST_INPUTS = "action_dist_inputs"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"


class SampleBatch(dict):
    """A column-oriented batch of experience.  Maps str → np.ndarray; all
    columns share leading dimension ``count``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, np.ndarray):
                self[k] = np.asarray(v)

    @property
    def count(self) -> int:
        for v in self.values():
            return int(v.shape[0])
        return 0

    def __len__(self) -> int:  # len(batch) == timesteps, not columns
        return self.count

    def copy(self) -> "SampleBatch":
        return SampleBatch({k: v.copy() for k, v in self.items()})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def shuffle(self, rng: np.random.Generator | None = None) -> "SampleBatch":
        rng = rng or np.random.default_rng()
        perm = rng.permutation(self.count)
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def minibatches(self, minibatch_size: int,
                    drop_last: bool = True) -> Iterator["SampleBatch"]:
        n = self.count
        end = n - (n % minibatch_size) if drop_last else n
        for i in range(0, end, minibatch_size):
            yield self.slice(i, min(i + minibatch_size, n))

    def split_by_episode(self) -> List["SampleBatch"]:
        if EPS_ID not in self:
            return [self]
        ids = self[EPS_ID]
        # Episode boundaries = positions where eps_id changes.
        cuts = np.flatnonzero(ids[1:] != ids[:-1]) + 1
        bounds = [0, *cuts.tolist(), len(ids)]
        return [self.slice(a, b) for a, b in zip(bounds[:-1], bounds[1:])]

    @staticmethod
    def concat_samples(batches: Sequence["SampleBatch"]) -> "SampleBatch":
        batches = [b for b in batches if b.count > 0]
        if not batches:
            return SampleBatch()
        keys = set(batches[0])
        for b in batches[1:]:
            keys &= set(b)
        return SampleBatch(
            {k: np.concatenate([b[k] for b in batches]) for k in keys})

    def as_dict(self) -> Dict[str, np.ndarray]:
        return dict(self)

    def size_bytes(self) -> int:
        return sum(v.nbytes for v in self.values())

    def __repr__(self) -> str:
        cols = {k: tuple(v.shape) for k, v in self.items()}
        return f"SampleBatch({self.count}: {cols})"


def concat_samples(batches: Sequence[SampleBatch]) -> SampleBatch:
    return SampleBatch.concat_samples(batches)


class MultiAgentBatch:
    """Per-policy batches from one multi-agent sampling round (reference:
    ``rllib/policy/sample_batch.py::MultiAgentBatch``)."""

    def __init__(self, policy_batches: Dict[str, SampleBatch],
                 env_steps: int):
        self.policy_batches = dict(policy_batches)
        self._env_steps = int(env_steps)

    def env_steps(self) -> int:
        return self._env_steps

    @property
    def count(self) -> int:
        return self._env_steps

    def agent_steps(self) -> int:
        return sum(b.count for b in self.policy_batches.values())

    @staticmethod
    def concat_samples(batches: Sequence["MultiAgentBatch"]) -> "MultiAgentBatch":
        per_policy: Dict[str, List[SampleBatch]] = {}
        steps = 0
        for b in batches:
            steps += b.env_steps()
            for pid, sb in b.policy_batches.items():
                per_policy.setdefault(pid, []).append(sb)
        return MultiAgentBatch(
            {pid: SampleBatch.concat_samples(v)
             for pid, v in per_policy.items()}, steps)

    def __repr__(self) -> str:
        return (f"MultiAgentBatch(env_steps={self._env_steps}, "
                f"{ {p: b.count for p, b in self.policy_batches.items()} })")
