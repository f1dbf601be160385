"""The learners ported so far (``ray_tpu/rllib/algorithms/``): PPO,
IMPALA with V-trace and APPO on its learner, and DQN.  SAC, DDPG/TD3 and
MARWIL/BC come next; A3C, Ape-X and ES wait for the runtime (ROADMAP
queue A)."""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig

__all__ = ["Algorithm", "AlgorithmConfig", "PPO", "PPOConfig",
           "IMPALA", "IMPALAConfig", "DQN", "DQNConfig", "APPO",
           "APPOConfig"]
