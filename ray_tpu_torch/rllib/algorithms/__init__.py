"""The algorithms of ``ray_tpu/rllib/algorithms/``, every one of them:
PPO, IMPALA with V-trace (its async actor-learner) and APPO on it, DQN,
Ape-X (its replay-shard fleet, or its single-process path), SAC,
DDPG/TD3, MARWIL/BC over offline data, A3C (Hogwild, or its local mode)
and ES (its episodes are tasks of the port's runtime).  The learner runs
on the config's ``device`` (the card by default); remote rollout
workers, replay shards and ES's episodes run on the CPU."""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.apex import APEX, APEXConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.algorithms.ddpg import DDPG, DDPGConfig, TD3, TD3Config
from ray_tpu_torch.rllib.algorithms.es import ES, ESConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.a3c import A3C, A3CConfig
from ray_tpu_torch.rllib.algorithms.marwil import (BC, BCConfig, MARWIL,
                                                   MARWILConfig)

__all__ = ["Algorithm", "AlgorithmConfig", "PPO", "PPOConfig",
           "IMPALA", "IMPALAConfig", "DQN", "DQNConfig", "APEX", "APEXConfig",
           "SAC", "SACConfig", "ES", "ESConfig", "APPO", "APPOConfig",
           "A3C", "A3CConfig", "MARWIL", "MARWILConfig", "BC", "BCConfig",
           "DDPG", "DDPGConfig", "TD3", "TD3Config"]
