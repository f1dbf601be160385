"""The learners of ``ray_tpu/rllib/algorithms/`` that run on one card:
PPO, IMPALA with V-trace and APPO on its learner, DQN, Ape-X's
single-process path, SAC, DDPG/TD3, MARWIL/BC over offline data, and
A3C's local mode.  ES waits for the runtime: its rollouts are remote
tasks (ROADMAP queue A, slice 5), as are A3C's Hogwild path, Ape-X's
replay-shard fleet and IMPALA's async path."""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.apex import APEX, APEXConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.algorithms.ddpg import DDPG, DDPGConfig, TD3, TD3Config
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.a3c import A3C, A3CConfig
from ray_tpu_torch.rllib.algorithms.marwil import (BC, BCConfig, MARWIL,
                                                   MARWILConfig)

__all__ = ["Algorithm", "AlgorithmConfig", "PPO", "PPOConfig",
           "IMPALA", "IMPALAConfig", "DQN", "DQNConfig", "APEX", "APEXConfig",
           "SAC", "SACConfig", "APPO", "APPOConfig",
           "A3C", "A3CConfig", "MARWIL", "MARWILConfig", "BC", "BCConfig",
           "DDPG", "DDPGConfig", "TD3", "TD3Config"]
