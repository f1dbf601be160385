"""ray_tpu_torch.rllib: the reference's RLlib on one GPU (port of
``ray_tpu/rllib/``, module for module).

Reference: ``rllib/``.  A rollout worker steps vectorized envs on the host
with one device call a step for the policy; a learner is eager PyTorch on
the same device (PPO: all SGD epochs with no host read; IMPALA/APPO:
V-trace plus RMSProp; DQN and Ape-X's local path: double-Q, Ape-X over
prioritized replay; SAC, DDPG/TD3: actor, critics and targets; MARWIL/BC:
offline JSON data, ``offline.py``; A3C's local mode: worker-side
gradients).  Entry points run on the card unless the config says
``device="cpu"`` (``.resources(device="cpu")``).  Sampling is local
(``num_workers=0``); remote rollout workers, and with them ES, wait for
the runtime::

    from ray_tpu_torch.rllib import PPOConfig
    algo = (PPOConfig().environment("PixelSquareEnv")
            .rollouts(num_workers=0, num_envs_per_worker=8,
                      rollout_fragment_length=256)
            .training(train_batch_size=2048, sgd_minibatch_size=256,
                      num_sgd_iter=8, lr=3e-4)
            .debugging(seed=0).build())
    result = algo.train()
"""

from ray_tpu_torch.rllib.sample_batch import (MultiAgentBatch, SampleBatch,
                                              concat_samples)
from ray_tpu_torch.rllib.env import (MultiAgentEnv, RandomEnv, VectorEnv,
                                     make_multi_agent, register_env)
from ray_tpu_torch.rllib.policy import Policy, compute_gae
from ray_tpu_torch.rllib.evaluation import (
    RolloutWorker, WorkerSet, collect_metrics, synchronous_parallel_sample)
from ray_tpu_torch.rllib.multi_agent import MultiAgentRolloutWorker
from ray_tpu_torch.rllib.algorithms import (
    A3C, A3CConfig, APEX, APEXConfig, APPO, APPOConfig, Algorithm,
    AlgorithmConfig, BC, BCConfig, DDPG, DDPGConfig, DQN, DQNConfig, IMPALA,
    IMPALAConfig, MARWIL, MARWILConfig, PPO, PPOConfig, SAC, SACConfig, TD3,
    TD3Config)
from ray_tpu_torch.rllib.algorithms.impala import vtrace

__all__ = [
    "SampleBatch", "MultiAgentBatch", "concat_samples", "RandomEnv",
    "VectorEnv", "register_env", "MultiAgentEnv", "make_multi_agent",
    "Policy", "compute_gae", "RolloutWorker", "MultiAgentRolloutWorker",
    "WorkerSet", "collect_metrics", "synchronous_parallel_sample",
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "IMPALA",
    "IMPALAConfig", "DQN", "DQNConfig", "APEX", "APEXConfig", "vtrace",
    "APPO", "APPOConfig", "A3C", "A3CConfig", "MARWIL", "MARWILConfig",
    "BC", "BCConfig", "SAC", "SACConfig", "DDPG", "DDPGConfig", "TD3",
    "TD3Config",
]
