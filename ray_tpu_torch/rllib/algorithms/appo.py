"""APPO: IMPALA's learner with PPO's clipped surrogate (port of
``ray_tpu/rllib/algorithms/appo.py``).

Reference: ``rllib/algorithms/appo/`` — the IMPALA architecture (async
actor fleet, V-trace off-policy correction, broadcast-interval weight
staleness) with PPO's clipped importance-ratio surrogate as the policy
loss instead of the plain V-trace policy gradient.  The execution path
(futures pipeline, time-major columns, learner device, the
``sync_sampling`` control) is inherited from ``IMPALA``; only the
policy-surrogate term differs — the ratio uses the BEHAVIOR logp as the
"old" policy, so staleness itself is what gets clipped.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig


class APPOConfig(IMPALAConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or APPO)
        self._cfg.update({
            "clip_param": 0.3,          # reference APPO default (0.4 torch)
            # APPO leans on the surrogate clip rather than aggressive
            # rho-clipping for stability
            "entropy_coeff": 0.005,
        })


class APPO(IMPALA):
    _default_config_cls = APPOConfig

    @staticmethod
    def _policy_surrogate(config):
        clip = float(config.get("clip_param", 0.3))

        def clipped(target_logp, behavior_logp, pg_adv):
            ratio = torch.exp(target_logp - behavior_logp)
            return -torch.minimum(
                ratio * pg_adv,
                torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * pg_adv).mean()
        return clipped
